"""Checkpoints of the port (counterpart of ``repro/train/checkpoint.py``),
in the reference's format, so that a checkpoint written by either package
restores into the other.

One ``step_<N>/`` directory (N zero-padded to 8 digits) holds

* ``arrays.npz``: every leaf of the state by its dict path joined with
  ``::``; a bf16 leaf is stored as f32 under ``<path>@bf16`` (exact, and
  read back bit for bit); the step counter is int32; the port's int64 run
  seed is stored under ``rng`` as the reference's key
  ``PRNGKey(seed)``, uint32 ``[0, seed]``;
* ``meta.msgpack``: a map of the step, the CRC32 of ``arrays.npz``, the
  number of arrays and the device count (plus the caller's ``extra``),
  written and read by the small MessagePack codec below (``packb``,
  ``unpackb``);
* ``DONE``, written last: the directory is written as ``step_<N>.tmp``
  and renamed, so a crash leaves no ``DONE`` and restore skips it.

The port's step updates params, optimizer and controller state in place,
so ``save`` copies every leaf to host numpy on the caller's thread before
an asynchronous writer starts; a writer's error is raised again on the
next ``wait`` or ``save``. ``restore(template)`` puts each leaf on the
template leaf's device and in its dtype.
"""
from __future__ import annotations

import io
import os
import shutil
import struct
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import interop

_SEP = "::"
_SEED = "rng"               # the top-level key of the run seed


# ---------------------------------------------------------------------------
# MessagePack: the types the meta map holds (map, str, int up to 64 bits,
# float64, bool, nil), each in its shortest form, as the msgpack
# package's packb writes them.


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += bytes((0xD9, n))
        elif n < 1 << 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += data
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 1 << 16:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"meta value of type {type(obj).__name__}: {obj!r}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    tags = (((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
             (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)) if v >= 0 else
            ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
             (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)))
    for tag, fmt, limit in tags:
        if (v < limit) if v >= 0 else (v >= -limit):
            out += bytes((tag,)) + struct.pack(fmt, v)
            return
    raise OverflowError(f"int {v} outside [-2^63, 2^64)")


# tag → (struct format, size) of the fixed-width scalars
_SCALARS = {0xCB: (">d", 8),
            0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# tag → (struct format, size) of a str's or a map's length
_LENGTHS = {0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4),
            0xDE: (">H", 2), 0xDF: (">I", 4)}


def unpackb(data: bytes):
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the meta map")
    return obj


def _unpack(buf, i: int):
    tag = buf[i]
    i += 1
    if tag < 0x80 or tag >= 0xE0:
        return (tag if tag < 0x80 else tag - 0x100), i
    if tag in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[tag], i
    if tag in _SCALARS:
        fmt, size = _SCALARS[tag]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if 0xA0 <= tag < 0xC0 or 0x80 <= tag < 0x90:
        n = tag & (0x1F if tag >= 0xA0 else 0x0F)
    elif tag in _LENGTHS:
        fmt, size = _LENGTHS[tag]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += size
    else:
        raise ValueError(f"MessagePack tag 0x{tag:02x} is not a meta type")
    if tag >= 0xA0 and tag not in (0xDE, 0xDF):           # a str
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


# ---------------------------------------------------------------------------
# The state as flat host arrays


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def flatten_state(state) -> Dict[str, np.ndarray]:
    """{``::``-joined path: a host copy} of every leaf (the caller may
    update the state in place once this returns)."""
    flat = {}
    for path, leaf in _leaves(state):
        key = _SEP.join(path)
        t = leaf.detach()
        if path == (_SEED,):
            seed = int(t)
            if not 0 <= seed < 1 << 32:
                raise ValueError(f"run seed {seed} has no PRNGKey(seed) form")
            flat[key] = np.array([0, seed], dtype=np.uint32)
        elif t.dtype == torch.bfloat16:
            flat[key + "@bf16"] = t.cpu().to(torch.float32).numpy()
        else:
            flat[key] = t.to("cpu", copy=True).numpy()
    return flat


def unflatten_into(template, flat: Dict[str, np.ndarray]):
    """A state with ``template``'s structure from the flat arrays, each
    leaf on the template leaf's device and in its dtype. Raises KeyError
    on a missing leaf and ValueError on a shape that differs."""
    def visit(tree, path):
        if isinstance(tree, dict):
            return {k: visit(v, path + (str(k),)) for k, v in tree.items()}
        key = _SEP.join(path)
        if path == (_SEED,):
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            return interop.seed_from_key(flat[key]).to(tree.device)
        if key in flat:
            arr = torch.from_numpy(np.array(flat[key]))
        elif key + "@bf16" in flat:
            arr = torch.from_numpy(np.array(flat[key + "@bf16"]))
        else:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                             f"state shape {tuple(tree.shape)}")
        return arr.to(device=tree.device, dtype=tree.dtype)
    return visit(template, ())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, state, step: int, extra: Optional[dict] = None):
        if "layout" in state:
            raise NotImplementedError(
                "checkpoints of a state held in blocks are not ported: "
                "ROADMAP.md Queue 1 item 13")
        flat = flatten_state(state)   # host copies on the caller's thread
        if self.async_save:
            self.wait()               # raises a prior writer's failure
            self._thread = threading.Thread(
                target=self._write_guarded, args=(flat, step, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(flat, step, extra or {})

    def wait(self):
        """Join the writer in flight; an exception it met (disk full, a bad
        path) is raised here, so the loop learns at its next save or wait
        that its checkpoints are not landing."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise IOError(f"async checkpoint save failed: {err}") from err

    def _write_guarded(self, flat, step, extra):
        try:
            self._write(flat, step, extra)
        except BaseException as e:      # noqa: BLE001 — reported on wait
            self._error = e

    def _write(self, flat: Dict[str, np.ndarray], step: int, extra: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        buf = io.BytesIO()
        np.savez(buf, **flat)
        data = buf.getvalue()
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            f.write(data)
        meta = {"step": step, "crc32": zlib.crc32(data),
                "num_arrays": len(flat),
                "device_count": (torch.cuda.device_count()
                                 if torch.cuda.is_available() else 1),
                **extra}
        with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
            f.write(packb(meta))
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name, "DONE")):
                out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "arrays.npz"), "rb") as f:
            data = f.read()
        meta = self.restore_meta(step)
        if zlib.crc32(data) != meta["crc32"]:
            raise IOError(f"checkpoint step {step} failed CRC — torn write?")
        arrays = dict(np.load(io.BytesIO(data)))
        return unflatten_into(template, arrays)

    def restore_meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = step if step is not None else self.latest_step()
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.msgpack"), "rb") as f:
            return unpackb(f.read())
