"""Training observability (counterpart of ``repro/train/metrics.py``, the
same files): one JSON line per event, a flat schema, flushed as it goes.

    logger = MetricsLogger("runs/exp1")
    logger.log_step(step, {"loss": ..., "lr": ...}, dt=0.42)
    logger.log_switch(step, controller.snapshot(state["adapt"]))
    logger.close()

``wl_summary`` condenses a controller snapshot into the scalars a
dashboard reads (mean/min/max WL, the mean nonzero fraction, the paper's
model-size units Σ sp·WL); the per-tensor arrays go to the switch log.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


def wl_summary(snapshot: Dict[str, Dict[str, Any]]) -> Dict[str, float]:
    if not snapshot:
        return {}
    wls = np.concatenate([np.atleast_1d(np.asarray(t["wl"], np.float32))
                          for t in snapshot.values()])
    sps = np.concatenate([np.atleast_1d(np.asarray(t["sp"], np.float32))
                          for t in snapshot.values()])
    return {
        "wl_mean": float(wls.mean()),
        "wl_min": float(wls.min()),
        "wl_max": float(wls.max()),
        "nonzero_mean": float(sps.mean()),
        "size_units": float((wls * sps).sum()),   # paper's sz = Σ sp·WL
        "num_tensors": int(len(snapshot)),
    }


class MetricsLogger:
    """``<run_name>.metrics.jsonl`` (steps and events) and
    ``<run_name>.switches.jsonl`` (precision switches) in ``directory``,
    appended to."""

    def __init__(self, directory: str, run_name: str = "run",
                 flush_every: int = 20):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{run_name}.metrics.jsonl")
        self.switch_path = os.path.join(directory,
                                        f"{run_name}.switches.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._fs = open(self.switch_path, "a", buffering=1)
        self._n = 0
        self.flush_every = flush_every

    def _emit(self, f, record: Dict[str, Any]):
        record.setdefault("t", time.time())
        f.write(json.dumps(record) + "\n")
        self._n += 1
        if self._n % self.flush_every == 0:
            f.flush()

    def log_step(self, step: int, metrics: Dict[str, Any],
                 dt: Optional[float] = None):
        rec = {"kind": "step", "step": step,
               **{k: float(v) for k, v in metrics.items()}}
        if dt is not None:
            rec["dt_s"] = dt
        self._emit(self._f, rec)

    def log_switch(self, step: int, snapshot: Dict[str, Dict[str, Any]]):
        self._emit(self._fs, {
            "kind": "switch", "step": step, **wl_summary(snapshot),
            "tensors": {k: {"wl": np.asarray(v["wl"]).tolist(),
                            "fl": np.asarray(v["fl"]).tolist(),
                            "sp": np.asarray(v["sp"]).tolist()}
                        for k, v in snapshot.items()},
        })

    def log_event(self, kind: str, **fields):
        self._emit(self._f, {"kind": kind, **fields})

    def close(self):
        self._f.flush()
        self._f.close()
        self._fs.flush()
        self._fs.close()


def read_jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
