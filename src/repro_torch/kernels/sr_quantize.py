"""Stochastic-rounding int8 words with the noise drawn inside the kernel:
the CUDA kernels of ``csrc/sr_quantize.cu`` beside their plain versions,
and the contract pieces of the portable noise stream.

* ``sr_quantize_fused_int8`` replaces the TPU kernel
  ``_sr_fused_int8_kernel`` of ``repro/kernels/sr_quantize.py`` (an
  unstacked leaf: element i hashes index i).
* ``sr_quantize_fused_stacked_int8`` replaces
  ``_sr_fused_stacked_int8_kernel`` (an (L, ...) leaf with a per-layer FL:
  element i of layer l hashes l·rows·512 + i, rows = ⌈n_l / 512⌉).

Both give q = clip(floor(x·2^fl) + [u < frac], −128, 127) as int8 from the
f32 master, u = ``uniform_from_index(seed, idx)``: the words are bit for
bit those of the reference's portable stream (its interpret mode). The TPU
hardware PRNG has no counterpart. On an H100 both are bound by their bytes
(4 read and 1 written per element). A CPU tensor takes the plain version;
a CUDA tensor takes the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.fxp_matmul import check_card

plain = ref.ref_sr_quantize_fused_int8_words
plain_stacked = ref.ref_sr_quantize_fused_stacked_int8_words

# One implementation of the shard-seed fold; tests pin it to the golden file.
fold_shard_seed = ref.ref_fold_shard_seed


def uniform_from_index(seed, idx: torch.Tensor) -> torch.Tensor:
    """Portable U[0,1) f32 of element indices ``idx`` (taken mod 2^32):
    the murmur3 finalizer of idx + seed·0x9E3779B9, u = (h >> 8)·2^-24
    (``repro/kernels/sr_quantize.py:113``)."""
    h = torch.as_tensor(idx).to(torch.int64).bitwise_and(ref._M32)
    return ref._uniform(seed, h)


def _lib():
    lib = _build.load("sr_quantize")
    flat, stacked = (lib.sr_quantize_fused_int8_launch,
                     lib.sr_quantize_fused_stacked_int8_launch)
    if flat.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        flat.argtypes = [p, p, p, i, ll, p]
        flat.restype = ctypes.c_int
        stacked.argtypes = [p, p, p, i, i, ll, p]
        stacked.restype = ctypes.c_int
    return flat, stacked


def _seed32(seed) -> int:
    """The seed as the int32 the kernels reinterpret as uint32."""
    s = int(seed) & ref._M32
    return s - (1 << 32) if s >= (1 << 31) else s


def _check(name: str, x: torch.Tensor, fl: torch.Tensor, fl_shape) -> None:
    check_card(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous float32, got "
                         f"{x.dtype}")
    if fl.dtype != torch.int32 or fl.device != x.device \
            or tuple(fl.shape) != fl_shape:
        raise ValueError(f"{name}: fl must be int32 {fl_shape} on "
                         f"{x.device}, got {fl.dtype} {tuple(fl.shape)} on "
                         f"{fl.device}")


def _fl_on(fl, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(fl, dtype=torch.int32, device=x.device)


def sr_quantize_fused_int8(x: torch.Tensor, seed, fl) -> torch.Tensor:
    """int8 SR words of an unstacked tensor at one FL (a 0-dim int32
    tensor, read by the kernel on the card). ``seed``: a host int (int32
    bits). Same shape as x."""
    fl = _fl_on(fl, x)
    if x.device.type == "cpu":
        return plain(x, seed, fl)
    x = x.to(torch.float32).contiguous()
    _check("sr_quantize_fused_int8", x, fl, ())
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()[0](x.data_ptr(), q.data_ptr(), fl.data_ptr(), _seed32(seed),
                    x.numel(), stream)
    _build.check(err, "sr_quantize_fused_int8")
    sr_quantize_fused_int8.launches += 1
    return q


sr_quantize_fused_int8.launches = 0


def sr_quantize_fused_stacked_int8(x: torch.Tensor, seed, fl) -> torch.Tensor:
    """int8 SR words of an (L, ...) stacked tensor, layer l at ``fl[l]``
    (an (L,) int32 tensor, read by the kernel on the card), in one
    launch. Same shape as x."""
    fl = _fl_on(fl, x)
    if x.device.type == "cpu":
        return plain_stacked(x, seed, fl)
    x = x.to(torch.float32).contiguous()
    L = x.shape[0]
    _check("sr_quantize_fused_stacked_int8", x, fl, (L,))
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()[1](x.data_ptr(), q.data_ptr(), fl.data_ptr(), _seed32(seed),
                    L, x[0].numel() if L else 0, stream)
    _build.check(err, "sr_quantize_fused_stacked_int8")
    sr_quantize_fused_stacked_int8.launches += 1
    return q


sr_quantize_fused_stacked_int8.launches = 0
