"""Continuous-batching request scheduler over the serve engine (counterpart
of ``repro/serve/scheduler.py``, with its public API and semantics).

Requests arrive with different prompt lengths and generation budgets. The
scheduler keeps a fixed pool of ``slots`` (the decode has a static batch
dimension), admits queued requests into free slots between decode steps and
retires sequences as they hit their token budget or EOS: continuous
batching (Orca/vLLM style) over a *static* batch. Each slot owns one row of
the shared caches; a prompt streams through decode steps, one token a step.

The reference vmaps a single-row decode over the slots and jits it once.
The port decodes the pool as one batch of S rows, each row at its own
position (``transformer.decode_step`` with a (S,) position tensor), and on
the card captures that decode in a CUDA graph per serving level at
construction: the graphs read the level's word tree and share static
buffers (tokens, positions, the caches, the logits), so a step copies its
inputs in and replays the active level's graph. ``decode_captures`` counts
captures, the counterpart of the reference's jit cache size: it equals the
number of levels after construction and never grows, across steps,
precision swaps, quarantines and admissions. Every write to that state is
in place (a rebound buffer would leave a graph reading stale memory). On
the CPU the same decode runs eagerly and ``decode_captures`` stays 0.

Overload & fault behavior (the reference's contract):

* Every submitted request reaches EXACTLY ONE typed terminal status —
  ``ok | rejected | timed_out | evicted | failed`` — recorded in
  ``ContinuousBatcher.terminal``. Admission control rejects over-long
  prompts (they would silently wrap the ring cache) and queue-full
  submissions at ``submit()``; queued requests whose deadline passes are
  expired as ``timed_out``.
* Fault tolerance: serving state is reconstructible from the request
  JOURNAL (``serve/journal.py``). On replica loss,
  ``ContinuousBatcher.recover`` rebuilds a batcher that re-admits every
  request the dead replica never finished. A slot whose decode produces
  non-finite logits is quarantined (cache rows zeroed) and its request
  re-admitted from scratch within a bounded per-request retry budget;
  transient decode errors are retried in-step first.
* Degradation (AdaBits-style): under queue pressure a
  ``serve/policy.PrecisionPolicy`` drops the serving word length; the
  batcher swaps between pre-materialized word sets of one layout
  (``engine.quantize_serving_levels``), each with its captured graph.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.config import Config
from repro_torch.core import threefry
from repro_torch.core.controller import flatten_with_path
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.engine import (check_decoder, quantize_for_serving,
                                      quantize_serving_levels, sample)
from repro_torch.serve.faults import FaultInjector, TransientDecodeError
from repro_torch.serve.journal import RequestJournal
from repro_torch.serve.policy import PrecisionPolicy


class Status(str, enum.Enum):
    """Request lifecycle. PENDING/ACTIVE are transient; the rest are the
    typed TERMINAL statuses of the serving contract."""
    PENDING = "pending"        # queued, not yet in a slot
    ACTIVE = "active"          # owns a slot
    OK = "ok"                  # completed its token budget / EOS
    REJECTED = "rejected"      # refused at admission (typed ``reason``)
    TIMED_OUT = "timed_out"    # deadline passed while queued
    EVICTED = "evicted"        # replica shutdown; re-admittable elsewhere
    FAILED = "failed"          # decode faults exhausted the retry budget


TERMINAL = frozenset((Status.OK, Status.REJECTED, Status.TIMED_OUT,
                      Status.EVICTED, Status.FAILED))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    deadline: Optional[float] = None    # absolute, on the batcher's clock
    submit_time: float = 0.0
    # filled by the scheduler
    output: List[int] = dataclasses.field(default_factory=list)
    status: Status = Status.PENDING
    reason: str = ""                    # set with REJECTED/TIMED_OUT/FAILED
    retries_left: int = 0

    @property
    def done(self) -> bool:
        return self.status in TERMINAL


class DrainTimeout(RuntimeError):
    """``run_until_drained`` hit its step budget with work still in
    flight. Carries the drain report instead of silently stranding it."""

    def __init__(self, unfinished, done, steps):
        self.unfinished = tuple(unfinished)   # rids still queued/active
        self.done = done                      # requests finished so far
        self.steps = steps
        super().__init__(
            f"run_until_drained: {len(self.unfinished)} request(s) still "
            f"in flight after {steps} steps: {sorted(self.unfinished)}")


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0                 # absolute position of the next token
    pending: List[int] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.request is None


class ContinuousBatcher:
    """Explicit kwargs override ``cfg.serve``; ``clock`` must be monotonic
    (injectable for deterministic deadline tests). ``device`` defaults to
    ``cuda`` and raises on a host without CUDA unless ``device="cpu"``;
    every tensor of ``params`` must lie on it. An encoder raises
    ``ValueError`` (``engine.check_decoder``). A VLM's cross slots read
    the zeros of ``init_caches``: the reference's batcher takes no image
    memory, and neither does this one."""

    def __init__(self, cfg: Config, params, adapt_state=None, *,
                 slots: Optional[int] = None,
                 max_context: Optional[int] = None, seed: int = 0,
                 max_queue: Optional[int] = None,
                 retry_budget: Optional[int] = None,
                 transient_retries: Optional[int] = None,
                 default_timeout: Optional[float] = None,
                 policy: Optional[PrecisionPolicy] = None,
                 faults: Optional[FaultInjector] = None,
                 journal_path: str = "",
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        check_decoder(cfg)
        self.device = resolve_device(device)
        for path, leaf in flatten_with_path(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"ContinuousBatcher on {self.device}: param "
                                 f"{path} lies on {leaf.device}")
        scfg = cfg.serve
        self.cfg = cfg
        self.m = cfg.model
        n_slots = slots if slots is not None else scfg.slots
        self.slots = [_Slot() for _ in range(n_slots)]
        self.max_context = (max_context if max_context is not None
                            else scfg.max_context)
        self.max_queue = max_queue if max_queue is not None else scfg.max_queue
        self.retry_budget = (retry_budget if retry_budget is not None
                             else scfg.retry_budget)
        self.transient_retries = (transient_retries
                                  if transient_retries is not None
                                  else scfg.transient_retries)
        self.default_timeout = (default_timeout if default_timeout is not None
                                else scfg.default_timeout)
        self.clock = clock
        self.policy = policy
        self.faults = faults
        self.journal = RequestJournal(journal_path) if journal_path else None
        adapt_state = adapt_state or {}
        # AdaBits degradation: one pre-materialized word set per level, of
        # one layout (asserted at load), swapped between steps. Without a
        # policy there is a single tree, under the key None.
        if policy is not None:
            self.qparam_levels = quantize_serving_levels(
                params, adapt_state, cfg.quant, policy.levels)
            self.active_wl = next(iter(self.qparam_levels))
            self.qparams = self.qparam_levels[self.active_wl]
        else:
            self.qparam_levels = {}
            self.active_wl = None
            self.qparams = quantize_for_serving(params, adapt_state,
                                                cfg.quant)
        self.queue: collections.deque = collections.deque()
        self.terminal: Dict[int, Request] = {}   # rid → request, set once
        self.wl_trace: List[int] = []            # active WL per step
        self.stats = collections.Counter()
        self._next_rid = 0
        self._key = threefry.key_from_seed(seed)
        self._step_i = 0
        self._waits: collections.deque = collections.deque(maxlen=256)
        # the decode's static state: inputs (row 0 tokens, row 1 positions),
        # caches and logits, written in place only
        self.caches = transformer.init_caches(self.m, n_slots,
                                              self.max_context,
                                              device=self.device)
        self._inputs = torch.zeros((2, n_slots), dtype=torch.int32,
                                   device=self.device)
        self._logits = torch.zeros((n_slots, self.m.vocab_size or 1),
                                   dtype=torch.float32, device=self.device)
        self.decode_captures = 0
        self._graphs: Dict[Optional[int], torch.cuda.CUDAGraph] = {}
        if self.device.type == "cuda":
            self._capture()

    # -- the decode ----------------------------------------------------------

    def _decode_into(self, qparams) -> None:
        """One decode step of the whole slot pool from the static inputs:
        the caches are updated in place and the logits copied into
        ``self._logits``."""
        logits, _ = transformer.decode_step(
            qparams, self.m, self._inputs[0], self.caches, self._inputs[1],
            use_pallas=self.cfg.quant.use_pallas)
        self._logits.copy_(logits)

    def _trees(self) -> Dict[Optional[int], dict]:
        return self.qparam_levels or {None: self.qparams}

    @torch.inference_mode()
    def _capture(self) -> None:
        """One CUDA graph of ``_decode_into`` per serving level, in one
        memory pool (the graphs replay one at a time). A warm-up on a side
        stream first loads every kernel outside the capture; the caches it
        wrote are zeroed after. A capture that fails raises: there is no
        eager decode on the card."""
        trees = self._trees()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_into(next(iter(trees.values())))
        torch.cuda.current_stream(self.device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for wl, tree in trees.items():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                self._decode_into(tree)
            self._graphs[wl] = graph
            self.decode_captures += 1
        for c in self.caches.values():
            for t in c.values():
                t.zero_()
        self._logits.zero_()
        torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _decode(self, tokens: List[int], positions: List[int]) -> torch.Tensor:
        """Copy the step's inputs into the static buffers (one host-to-device
        copy on the card) and run the active level's decode: the graph's
        replay on the card, the eager decode on the CPU. Returns the static
        (S, V) logits."""
        self._inputs.copy_(torch.tensor([tokens, positions],
                                        dtype=torch.int32))
        if self._graphs:
            self._graphs[self.active_wl].replay()
        else:
            self._decode_into(self.qparams)
        return self._logits

    @torch.inference_mode()
    def _read_back(self, logits: torch.Tensor):
        """The step's one device-to-host copy: the greedy token and the
        finiteness of every row, and the draw of every row that samples at
        a temperature this step, on the device under the reference's keys
        (``fold_in(PRNGKey(seed), step)``, then ``fold_in(key, row)``).
        Returns (greedy, finite, {row: token})."""
        S = len(self.slots)
        rows = [i for i, s in enumerate(self.slots)
                if not s.free and not s.pending and s.request.temperature > 0]
        key = threefry.fold_in(self._key, self._step_i) if rows else None
        parts = [torch.argmax(logits, dim=-1),
                 torch.isfinite(logits).all(dim=-1).to(torch.int64)]
        parts += [sample(logits[i][None], threefry.fold_in(key, i),
                         self.slots[i].request.temperature).to(torch.int64)
                  for i in rows]
        host = torch.cat(parts).cpu().tolist()
        return (host[:S], [bool(f) for f in host[S:2 * S]],
                dict(zip(rows, host[2 * S:])))

    # -- public API ----------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: Optional[int] = None, *,
               deadline: Optional[float] = None,
               timeout: Optional[float] = None,
               rid: Optional[int] = None) -> Request:
        """Admit a request (returns it, possibly already REJECTED with a
        typed ``reason``). ``timeout`` is seconds-from-now sugar for
        ``deadline``; ``cfg.serve.default_timeout`` applies when neither
        is given. ``rid`` is for journal replay only."""
        now = self.clock()
        if timeout is None and deadline is None and self.default_timeout > 0:
            timeout = self.default_timeout
        if deadline is None and timeout is not None:
            deadline = now + timeout
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid, list(prompt), max_new_tokens, temperature, eos_id,
                      deadline=deadline, submit_time=now,
                      retries_left=self.retry_budget)
        self.stats["submitted"] += 1
        if self.journal is not None:
            self.journal.record_submit(req)
        if len(req.prompt) >= self.max_context:
            # an over-long prompt would drain ``pending`` while ``pos``
            # wraps the ring cache, corrupting the slot — refuse it here
            self._finish(req, Status.REJECTED, "prompt_too_long")
            return req
        if self.max_queue and len(self.queue) >= self.max_queue:
            self._finish(req, Status.REJECTED, "queue_full")
            return req
        self.queue.append(req)
        return req

    def step(self) -> List[Request]:
        """Expire, (maybe) swap precision, admit, decode one token for
        every active slot, retire finished. Returns every request that
        reached a terminal status during this step."""
        now = self.clock()
        finished = self._expire(now)
        if self.policy is not None:
            self._observe_policy()
        self._admit(now)
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return finished
        tokens = [s.pending.pop(0) if s.pending else (s.request.output[-1]
                  if not s.free and s.request.output else 0)
                  for s in self.slots]
        positions = [s.pos for s in self.slots]
        try:
            logits = self._guarded_decode(tokens, positions)
        except TransientDecodeError as e:
            self._step_i += 1
            return finished + self._fault_all_active(str(e))
        self._step_i += 1
        # non-finite logits = corrupted slot state (bad cache row / flipped
        # bit): quarantine before any token from it reaches an output
        next_tokens, finite, drawn = self._read_back(logits)
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            if not finite[i]:
                finished += self._quarantine(i, "non_finite_logits")
                continue
            slot.pos += 1
            if slot.pending:        # still consuming the prompt
                continue
            req = slot.request
            tok = drawn[i] if req.temperature > 0 else next_tokens[i]
            req.output.append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos or \
                    slot.pos >= self.max_context - 1:
                self._finish(req, Status.OK)
                finished.append(req)
                self.slots[i] = _Slot()     # slot returns to the pool
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        """Step until queue and slots are empty; returns the requests that
        reached a terminal status. Raises ``DrainTimeout`` (naming the
        stranded request ids, with the partial results attached) instead
        of silently returning with work still in flight."""
        done: List[Request] = []
        for _ in range(max_steps):
            done += self.step()
            if not self.queue and all(s.free for s in self.slots):
                return done
        raise DrainTimeout(self._in_flight_rids(), done, max_steps)

    def evict_all(self, reason: str = "replica_shutdown") -> List[Request]:
        """Graceful replica shutdown: every queued/active request becomes
        ``evicted`` (terminal here; journal replay re-admits evicted
        requests on the replacement replica)."""
        out = []
        for i, slot in enumerate(self.slots):
            if not slot.free:
                self._finish(slot.request, Status.EVICTED, reason)
                out.append(slot.request)
                self.slots[i] = _Slot()
        while self.queue:
            req = self.queue.popleft()
            self._finish(req, Status.EVICTED, reason)
            out.append(req)
        return out

    @classmethod
    def recover(cls, cfg: Config, params, adapt_state=None, *,
                journal_path: str, **kwargs) -> "ContinuousBatcher":
        """Rebuild a batcher after replica loss: re-admit (preserving rids)
        every journaled request that never reached a terminal status on
        the dead replica, plus explicitly evicted ones."""
        pending = RequestJournal.unfinished(journal_path)
        cb = cls(cfg, params, adapt_state, journal_path=journal_path,
                 **kwargs)
        for ev in pending:
            cb.submit(ev["prompt"], ev["max_new_tokens"],
                      ev.get("temperature", 0.0), ev.get("eos_id"),
                      deadline=ev.get("deadline"), rid=ev["rid"])
        return cb

    @property
    def utilization(self) -> float:
        busy = sum(not s.free for s in self.slots)
        return busy / max(len(self.slots), 1)

    def p95_wait_ms(self) -> float:
        """p95 queue wait (submit → admission) over the recent window."""
        if not self._waits:
            return 0.0
        waits = sorted(self._waits)
        return waits[int(0.95 * (len(waits) - 1))] * 1e3

    # -- internals -----------------------------------------------------------

    def _in_flight_rids(self) -> List[int]:
        return ([r.rid for r in self.queue]
                + [s.request.rid for s in self.slots if not s.free])

    def _finish(self, req: Request, status: Status, reason: str = ""):
        """The single terminal transition. Asserts exactly-once."""
        if req.status in TERMINAL:
            raise AssertionError(
                f"request {req.rid} reached a second terminal status "
                f"{status.value!r} (already {req.status.value!r})")
        req.status = status
        req.reason = reason
        self.terminal[req.rid] = req
        self.stats[status.value] += 1
        if self.journal is not None:
            self.journal.record_terminal(req)

    def _expire(self, now: float) -> List[Request]:
        """Expire queued requests whose deadline passed (typed, exact)."""
        expired = [r for r in self.queue
                   if r.deadline is not None and now > r.deadline]
        if expired:
            self.queue = collections.deque(
                r for r in self.queue if r not in expired)
            for req in expired:
                self._finish(req, Status.TIMED_OUT, "deadline_expired")
        return expired

    def _observe_policy(self):
        wl = self.policy.observe(len(self.queue), self.p95_wait_ms())
        if wl in self.qparam_levels and wl != self.active_wl:
            # one layout (asserted at load): the level's graph, captured
            # at construction, replays; nothing is captured again
            self.qparams = self.qparam_levels[wl]
            self.active_wl = wl
            self.stats["precision_switches"] += 1
        self.wl_trace.append(self.active_wl if self.active_wl is not None
                             else self.policy.wl)

    def _admit(self, now: float):
        for i, slot in enumerate(self.slots):
            if not slot.free or not self.queue:
                continue
            req = self.queue.popleft()
            self._waits.append(now - req.submit_time)
            req.status = Status.ACTIVE
            # reset this slot's cache rows, then stream the prompt through
            self._zero_rows(i)
            self.slots[i] = _Slot(request=req, pos=0,
                                  pending=list(req.prompt))

    def _zero_rows(self, i: int) -> None:
        """Zero slot ``i``'s rows of every leaf of every cache (an
        attention slot's k/v, a mamba slot's conv window and SSM state), in
        place."""
        for c in self.caches.values():
            for t in c.values():
                t[:, i].zero_()

    def _guarded_decode(self, tokens, positions):
        """Decode with fault-injection hooks and bounded in-step retry of
        transient errors. An injected error raises before the decode runs,
        so ``self.caches`` is untouched and retry is safe."""
        attempts = self.transient_retries + 1
        for attempt in range(attempts):
            try:
                if self.faults is not None:
                    self.faults.before_decode(self._step_i, attempt)
                logits = self._decode(tokens, positions)
            except TransientDecodeError:
                self.stats["transient_decode_errors"] += 1
                if attempt == attempts - 1:
                    raise
                continue
            if self.faults is not None:
                logits = self.faults.corrupt_logits(self._step_i, logits)
            return logits

    def _quarantine(self, i: int, reason: str) -> List[Request]:
        """Slot ``i`` produced corrupt output: zero its cache rows so the
        poisoned state cannot leak into a future occupant, free it, and
        re-admit (or fail) the victim."""
        req = self.slots[i].request
        self._zero_rows(i)
        self.slots[i] = _Slot()
        self.stats["quarantines"] += 1
        return self._readmit_or_fail(req, reason)

    def _fault_all_active(self, reason: str) -> List[Request]:
        """In-step retries exhausted with no logits at all: every active
        request is a victim. Caches were never touched by the raising
        decode, but the slots restart their requests from scratch."""
        out = []
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.request
            self.slots[i] = _Slot()
            out += self._readmit_or_fail(req, reason)
        return out

    def _readmit_or_fail(self, req: Request, reason: str) -> List[Request]:
        """Bounded per-request retry: re-admit from scratch (front of the
        queue — the victim already waited) while budget remains, else the
        typed ``failed`` terminal."""
        if req.retries_left > 0:
            req.retries_left -= 1
            req.output = []
            req.status = Status.PENDING
            self.queue.appendleft(req)
            self.stats["retries"] += 1
            return []
        self._finish(req, Status.FAILED, reason)
        return [req]
