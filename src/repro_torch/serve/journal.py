"""Durable append-only request journal for the continuous batcher
(counterpart of ``repro/serve/journal.py``: the same events, keys and key
order, so a journal written by either package replays in the other).

The batcher is in-memory per replica; its fault-tolerance story is that
serving state is RECONSTRUCTIBLE from the request log. This module is
that log: one JSONL line per event, appended and flushed at submit and
at every terminal transition, so a replica that dies mid-flight can be
replaced by a fresh batcher that re-admits exactly the requests that
never reached a terminal status (plus any explicitly ``evicted`` ones —
evicted means "terminal on this replica, re-admit elsewhere").

Events::

    {"ev": "submit",   "rid": 3, "prompt": [...], "max_new_tokens": 8,
     "temperature": 0.0, "eos_id": null, "deadline": null,
     "submit_time": 12.5}
    {"ev": "terminal", "rid": 3, "status": "ok", "reason": "",
     "output": [...]}

Replay is torn-write tolerant: a truncated or garbage final line (the
crash happened mid-append) is skipped, never fatal. The last event per
rid wins, so re-submitting a replayed request appends a fresh submit
line and replay stays idempotent across repeated crashes.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List


class RequestJournal:
    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")

    def record_submit(self, req) -> None:
        self._append({
            "ev": "submit",
            "rid": req.rid,
            "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature,
            "eos_id": req.eos_id,
            "deadline": req.deadline,
            "submit_time": req.submit_time,
        })

    def record_terminal(self, req) -> None:
        self._append({
            "ev": "terminal",
            "rid": req.rid,
            "status": str(req.status.value),
            "reason": req.reason,
            "output": list(req.output),
        })

    def _append(self, obj: Dict[str, Any]) -> None:
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    # -- replay --------------------------------------------------------------

    @staticmethod
    def unfinished(path: str) -> List[Dict[str, Any]]:
        """Parse the journal and return the submit records (in submission
        order) of every request whose LAST event is not a terminal status
        — plus those whose last status is ``evicted`` (terminal locally,
        meant for re-admission on another replica). Corrupt/truncated
        lines are skipped."""
        if not os.path.exists(path):
            return []
        submits: Dict[int, Dict[str, Any]] = {}
        order: List[int] = []
        finished: Dict[int, str] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue                      # torn write: skip the tail
                rid = ev.get("rid")
                if ev.get("ev") == "submit" and rid is not None:
                    if rid not in submits:
                        order.append(rid)
                    submits[rid] = ev
                    finished.pop(rid, None)       # re-submitted after replay
                elif ev.get("ev") == "terminal" and rid is not None:
                    finished[rid] = ev.get("status", "")
        out = []
        for rid in order:
            status = finished.get(rid)
            if status is None or status == "evicted":
                out.append(submits[rid])
        return out
