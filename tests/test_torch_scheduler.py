"""Port parity for the continuous batcher (``serve/scheduler.py``) on a
trained ``tiny``, against the JAX reference's batcher on the CPU.

The module fixture trains ``tiny`` for 3 reference steps, as
``tests/test_serve_robustness.py`` does, and carries the state over with
``repro_torch.interop``. Each scenario then runs on both packages with the
same submissions, an injected clock where time matters, and each package's
own fault injector, policy and journal; the two must reach the same
terminal status and reason for every rid, the same ``stats`` and
``wl_trace``, and the same outputs, except after a near tie.

Near ties: the reference vmaps a single-row decode over the slots and the
port decodes the pool as one batch, so their bf16 activations may round
f32 sums taken in different orders to neighbouring values, and their logits
differ within 2^-5 of the largest logit (``tests/test_torch_model.py``).
The reference's decode is wrapped to record, for every token a slot emits,
the top-1/top-2 margin of its logits (under temperature, of its gumbel
scores under the reference's keys, against the tolerance over T); where
an output first differs from the reference's, that margin must be within
twice the tolerance, and later tokens of that request are not compared.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import load_config as jax_load_config  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.serve import faults as jax_faults  # noqa: E402
from repro.serve import policy as jax_policy  # noqa: E402
from repro.serve import scheduler as jax_scheduler  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine, faults, policy, scheduler  # noqa: E402

LEVELS = (8, 6, 4)


@pytest.fixture(scope="module")
def trained():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jax_load_config("tiny")
    state, _ = jax_train_loop.train(jcfg, steps=3, log=lambda s: None)
    npstate = jax.tree.map(np.asarray, state)
    yield dict(jcfg=jcfg, cfg=load_config("tiny"), state=state,
               tp=interop.params_from_numpy(npstate["params"], "cpu"),
               ta=interop.adapt_state_from_numpy(npstate["adapt"], "cpu"))
    torch.set_num_threads(threads)


def _flat(tree):
    """{key path: numpy leaf} of a tree of dicts."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# quantize_serving_levels


@pytest.mark.parametrize("container", ["float32", "int8_packed"])
def test_serving_levels_bit_equal_to_reference(trained, container):
    t = trained
    jq = jax_load_config("tiny", overrides=[
        f"quant.container_dtype={container}"]).quant
    q = load_config("tiny", overrides=[
        f"quant.container_dtype={container}"]).quant
    want = jax_engine.quantize_serving_levels(
        t["state"]["params"], t["state"]["adapt"], jq, LEVELS)
    got = engine.quantize_serving_levels(t["tp"], t["ta"], q, LEVELS)
    assert list(got) == list(want) == list(LEVELS)
    for wl in LEVELS:
        w, g = _flat(want[wl]), _flat(interop.to_numpy(got[wl]))
        assert sorted(w) == sorted(g)
        for path in w:
            assert g[path].dtype == w[path].dtype, (wl, path)
            assert g[path].shape == w[path].shape, (wl, path)
            np.testing.assert_array_equal(
                np.atleast_1d(g[path]).view(np.uint8),
                np.atleast_1d(w[path]).view(np.uint8),
                err_msg=f"WL={wl} {path}")
    # the degraded levels differ from full precision
    full, low = (_flat(interop.to_numpy(got[wl])) for wl in (8, 4))
    assert any(not np.array_equal(full[p], low[p]) for p in full)


@pytest.mark.parametrize("container", ["float32", "int8_packed"])
def test_serving_adapt_state_serves_the_same_words(trained, container):
    """The launcher's cut of the controller state (each tensor's ⟨WL,FL⟩,
    the same tensors, nothing else) quantizes every level to the same
    words as the whole training state."""
    t = trained
    q = load_config("tiny", overrides=[
        f"quant.container_dtype={container}"]).quant
    cut = engine.serving_adapt_state(t["ta"])
    assert list(cut) == ["tensors"] and list(cut["tensors"]) == list(
        t["ta"]["tensors"])
    for p, ts in cut["tensors"].items():
        assert list(ts) == ["wl", "fl"]
        assert ts["wl"] is t["ta"]["tensors"][p]["wl"]
        assert ts["fl"] is t["ta"]["tensors"][p]["fl"]
    whole = engine.quantize_serving_levels(t["tp"], t["ta"], q, LEVELS)
    got = engine.quantize_serving_levels(t["tp"], cut, q, LEVELS)
    for wl in LEVELS:
        w, g = (_flat(interop.to_numpy(x[wl])) for x in (whole, got))
        assert sorted(w) == sorted(g)
        for path in w:
            np.testing.assert_array_equal(
                np.atleast_1d(g[path]).view(np.uint8),
                np.atleast_1d(w[path]).view(np.uint8),
                err_msg=f"WL={wl} {path}")
    assert engine.serving_adapt_state({"tensors": {}}) == {"tensors": {}}
    assert engine.serving_adapt_state(None) == {"tensors": {}}


def test_serving_levels_passthrough_and_layout_check(trained, monkeypatch):
    t = trained
    out = engine.quantize_serving_levels(t["tp"], {"tensors": {}},
                                         t["cfg"].quant, LEVELS)
    assert list(out) == [8] and out[8] is t["tp"]
    with pytest.raises(ValueError, match="empty"):
        engine.quantize_serving_levels(t["tp"], t["ta"], t["cfg"].quant, ())
    real = engine.quantize_for_serving

    def odd_level(params, adapt_state, qcfg, max_wl=None):
        tree = real(params, adapt_state, qcfg, max_wl)
        if max_wl == 4:
            tree = {**tree, "final_norm": tree["final_norm"].double()}
        return tree

    monkeypatch.setattr(engine, "quantize_for_serving", odd_level)
    with pytest.raises(AssertionError, match="WL=4"):
        engine.quantize_serving_levels(t["tp"], t["ta"], t["cfg"].quant,
                                       LEVELS)

    def extra_path(params, adapt_state, qcfg, max_wl=None):
        tree = real(params, adapt_state, qcfg, max_wl)
        return {**tree, "extra": tree["final_norm"]} if max_wl == 6 else tree

    monkeypatch.setattr(engine, "quantize_for_serving", extra_path)
    with pytest.raises(AssertionError, match="WL=6"):
        engine.quantize_serving_levels(t["tp"], t["ta"], t["cfg"].quant,
                                       LEVELS)


# ---------------------------------------------------------------------------
# decode_step at per-row positions


def _caches_at(cfg, rng, slots, context):
    """Caches of ``slots`` rows with random bf16 entries (numpy, f32)."""
    out = {}
    for key, c in transformer.init_caches(cfg.model, slots, context,
                                          device="cpu").items():
        out[key] = {n: rng.standard_normal(tuple(c[n].shape)).astype(
            np.float32) for n in ("k", "v")}
    return out


def test_decode_step_at_row_positions_matches_vmapped_reference(trained):
    """The port's one-batch decode at a (S,) position tensor against the
    reference batcher's vmapped single-row ``_decode_fn`` on the same
    caches, tokens and positions (one row at a wrapped ring position), and
    the same new caches."""
    t = trained
    S, C = 4, 16
    rng = np.random.default_rng(0)
    caches = _caches_at(t["cfg"], rng, S, C)
    tokens = np.array([5, 0, 77, 200], np.int32)
    positions = np.array([3, 0, 15, 21], np.int32)
    jcb = jax_scheduler.ContinuousBatcher(
        t["jcfg"], t["state"]["params"], t["state"]["adapt"], slots=S,
        max_context=C)
    jc = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), caches)
    want, wcaches = jcb._decode(jcb.qparams, jnp.asarray(tokens), jc,
                                jnp.asarray(positions))
    cb = scheduler.ContinuousBatcher(t["cfg"], t["tp"], t["ta"], slots=S,
                                     max_context=C, device="cpu")
    tc = {k: {n: torch.from_numpy(v[n]).to(torch.bfloat16) for n in v}
          for k, v in caches.items()}
    before = {k: {n: c[n].clone() for n in c} for k, c in tc.items()}
    got, gcaches = transformer.decode_step(
        cb.qparams, t["cfg"].model, torch.from_numpy(tokens), tc,
        torch.from_numpy(positions))
    want = np.asarray(want)
    assert got.shape == want.shape == (S, t["cfg"].model.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2.0 ** -5 * np.abs(want).max())
    for key in caches:
        for n in ("k", "v"):
            w = np.asarray(wcaches[key][n], np.float32)
            g = gcaches[key][n]
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=2.0 ** -5 * np.abs(w).max())
            # each row wrote its own slot pos % C and nothing else
            changed = (g != before[key][n]).any(-1).any(-1).any(0)
            for b in range(S):
                assert torch.nonzero(changed[b]).flatten().tolist() == [
                    positions[b] % C], (key, n, b)


def test_int_position_path_unchanged(trained):
    """An int t decodes every row at t exactly as a tensor of t's does:
    the same logits and caches, bit for bit, so the ``Engine``'s path and
    the batcher's agree where they overlap."""
    t = trained
    S, C, pos = 3, 16, 6
    q = engine.quantize_for_serving(t["tp"], t["ta"], t["cfg"].quant)
    rng = np.random.default_rng(1)
    caches = _caches_at(t["cfg"], rng, S, C)
    tok = torch.tensor([1, 2, 3], dtype=torch.int32)
    runs = []
    for tt in (pos, torch.full((S,), pos, dtype=torch.int32)):
        c = {k: {n: torch.from_numpy(v[n]).to(torch.bfloat16) for n in v}
             for k, v in caches.items()}
        runs.append(transformer.decode_step(q, t["cfg"].model, tok, c, tt))
    (a, ca), (b, cb) = runs
    assert torch.equal(a, b)
    for key in ca:
        for n in ("k", "v"):
            assert torch.equal(ca[key][n], cb[key][n])


# ---------------------------------------------------------------------------
# The batcher, scenario by scenario, on both packages


class _Side:
    """What a scenario needs of one package: its batcher, fault injector,
    policy, statuses and errors, a journal directory, and (on the
    reference's side) the margins of every token its decode emitted."""

    def __init__(self, trained, ref: bool, tmp_path):
        self.t, self.ref = trained, ref
        self.dir = tmp_path / ("reference" if ref else "port")
        self.dir.mkdir()
        mods = (jax_scheduler, jax_faults, jax_policy) if ref else (
            scheduler, faults, policy)
        self.sched, self.faults, self.policy = mods
        self.Status = self.sched.Status
        self.margins = {}
        self.made = []

    def make(self, **kw):
        kw.setdefault("slots", 2)
        return self._track(self._cls()(*self._model(), **self._kw(kw)))

    def recover(self, **kw):
        return self._track(self._cls().recover(*self._model(),
                                               **self._kw(kw)))

    def _cls(self):
        return self.sched.ContinuousBatcher

    def _model(self):
        t = self.t
        return ((t["jcfg"], t["state"]["params"], t["state"]["adapt"])
                if self.ref else (t["cfg"], t["tp"], t["ta"]))

    def _kw(self, kw):
        """Defaults of every scenario: a context of 32 and a clock that
        ticks 1 ms a read (the journals' submit times), unless given."""
        kw.setdefault("max_context", 32)
        if "clock" not in kw:
            now = [0.0]

            def clock():
                now[0] += 1e-3
                return now[0]
            kw["clock"] = clock
        return kw if self.ref else {**kw, "device": "cpu"}

    def _track(self, cb):
        self.made.append(cb)
        if self.ref:
            self._record_margins(cb)
        return cb

    def _record_margins(self, cb):
        margins = self.margins.setdefault(len(self.made) - 1, {})
        inner = cb._decode

        def decode(qparams, tokens, caches, positions):
            logits, new = inner(qparams, tokens, caches, positions)
            lg = np.asarray(logits)
            tol = 2.0 ** -5 * float(np.abs(lg).max())
            key = jax.random.fold_in(cb._key, cb._step_i + 1)
            for i, s in enumerate(cb.slots):
                if s.free or s.pending:
                    continue
                row, temp = lg[i], s.request.temperature
                if temp > 0:
                    g = np.asarray(jax.random.gumbel(
                        jax.random.fold_in(key, i), (1, lg.shape[1])))[0]
                    row = g + row / temp
                top2 = np.sort(row)[-2:]
                margins[(s.request.rid, len(s.request.output))] = (
                    float(top2[1] - top2[0]),
                    tol / temp if temp > 0 else tol)
            return logits, new

        cb._decode = decode

    def journal(self, name):
        return str(self.dir / name)


def _same_batcher(rcb, pcb, margins):
    assert sorted(pcb.terminal) == sorted(rcb.terminal)
    for rid, r in rcb.terminal.items():
        p = pcb.terminal[rid]
        assert (p.status.value, p.reason) == (r.status.value, r.reason), rid
        _outputs_agree(rid, r.output, p.output, margins)
    assert dict(pcb.stats) == dict(rcb.stats)
    assert pcb.wl_trace == rcb.wl_trace
    assert [r.rid for r in pcb.queue] == [r.rid for r in rcb.queue]


def _outputs_agree(rid, ref, port, margins):
    for i, (a, b) in enumerate(zip(ref, port)):
        if a != b:
            gap, tol = margins[(rid, i)]
            assert gap <= 2 * tol, (rid, i, ref, port, gap, tol)
            return
    assert len(port) == len(ref), (rid, ref, port)


def s_engine(side):
    """test_scheduler.py::test_matches_static_engine: the batcher's greedy
    output is the static Engine's (on the port, both on the CPU)."""
    prompt = [3, 5, 7, 11, 13, 17, 19, 23]
    cb = side.make()
    req = cb.submit(prompt, max_new_tokens=6)
    cb.run_until_drained()
    t = side.t
    if side.ref:
        eng = jax_engine.Engine(t["jcfg"], t["state"]["params"],
                                t["state"]["adapt"])
        ref, _ = eng.generate(jnp.asarray([prompt], jnp.int32), 6)
    else:
        eng = engine.Engine(t["cfg"], t["tp"], t["ta"], device="cpu")
        ref, _ = eng.generate(torch.tensor([prompt], dtype=torch.int32), 6)
    assert req.output == [int(x) for x in np.asarray(ref)[0]]
    return {}


def s_staggered(side):
    cb = side.make()
    reqs = [cb.submit([i + 1, i + 2, i + 3], max_new_tokens=3 + i)
            for i in range(5)]
    done = cb.run_until_drained()
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    assert all(len(r.output) == r.max_new_tokens for r in done)
    assert cb.utilization == 0.0
    return {"order": [r.rid for r in done]}


def s_isolation(side):
    pa, pb = [2, 4, 6, 8], [30, 20, 10, 5]
    alone = []
    for prompt in (pa, pb):
        cb = side.make(slots=1)
        cb.submit(prompt, max_new_tokens=4)
        alone.append(cb.run_until_drained()[0].output)
    cb = side.make()
    ia = cb.submit(pa, max_new_tokens=4)
    ib = cb.submit(pb, max_new_tokens=4)
    cb.run_until_drained()
    assert [ia.output, ib.output] == alone
    return {}


def s_admission(side):
    cb = side.make(max_context=16)
    req = cb.submit(list(range(16)), max_new_tokens=4)
    assert (req.status.value, req.reason) == ("rejected", "prompt_too_long")
    ok = cb.submit(list(range(15)), max_new_tokens=1)
    assert ok.status.value == "pending"
    assert [r.status.value for r in cb.run_until_drained()] == ["ok"]
    cb = side.make(max_queue=3)
    reqs = [cb.submit([1, 2, 3], max_new_tokens=2) for _ in range(5)]
    assert [r.status.value for r in reqs] == ["pending"] * 3 + ["rejected"] * 2
    assert all(r.reason == "queue_full" for r in reqs[3:])
    cb.run_until_drained()
    return {}


def s_deadlines(side):
    now = [0.0]
    cb = side.make(slots=1, clock=lambda: now[0])
    fast = cb.submit([1, 2], max_new_tokens=2)
    slow = cb.submit([3, 4], max_new_tokens=2, timeout=5.0)
    cb.step()
    now[0] = 10.0
    cb.run_until_drained()
    assert (slow.status.value, slow.reason) == ("timed_out",
                                                "deadline_expired")
    assert fast.status.value == "ok"
    now = [100.0]
    cb = side.make(default_timeout=7.0, clock=lambda: now[0])
    a = cb.submit([1, 2], max_new_tokens=2)
    b = cb.submit([1, 2], max_new_tokens=2, deadline=200.0)
    now[0] = 150.0
    cb.run_until_drained()
    assert (a.deadline, b.deadline) == (107.0, 200.0)
    assert (a.status.value, b.status.value) == ("timed_out", "ok")
    return {"deadlines": [a.deadline, b.deadline]}


def s_drain_timeout(side):
    cb = side.make(slots=1)
    a = cb.submit([1, 2], max_new_tokens=8)
    b = cb.submit([3, 4], max_new_tokens=8)
    with pytest.raises(side.sched.DrainTimeout) as ei:
        cb.run_until_drained(max_steps=3)
    assert set(ei.value.unfinished) == {a.rid, b.rid}
    assert str(sorted(ei.value.unfinished)) in str(ei.value)
    partial = [r.rid for r in ei.value.done]
    done = cb.run_until_drained()
    assert {r.rid for r in done} == {a.rid, b.rid}
    return {"message": str(ei.value), "partial": partial,
            "steps": ei.value.steps}


def s_nan_retry(side):
    clean = side.make(slots=1)
    ref = clean.submit([5, 7, 9], max_new_tokens=4)
    clean.run_until_drained()
    fi = side.faults.FaultInjector(nan_steps={2: (0,)})
    cb = side.make(slots=1, faults=fi, retry_budget=2,
                   journal_path=side.journal("nan.jsonl"))
    req = cb.submit([5, 7, 9], max_new_tokens=4)
    cb.run_until_drained()
    assert req.status.value == "ok" and req.output == ref.output
    assert (cb.stats["retries"], cb.stats["quarantines"]) == (1, 1)
    assert fi.fired == [("nan", 2, (0,))]
    cb.journal.close()
    return {"fired": fi.fired}


def s_retry_exhausted(side):
    fi = side.faults.FaultInjector(nan_steps={s: (0,) for s in range(50)},
                                   corrupt_value=float("inf"))
    cb = side.make(slots=1, faults=fi, retry_budget=2)
    req = cb.submit([1, 2, 3], max_new_tokens=4)
    cb.run_until_drained()
    assert (req.status.value, req.reason) == ("failed", "non_finite_logits")
    assert cb.stats["retries"] == 2
    return {"fired": fi.fired}


def s_transient(side):
    fi = side.faults.FaultInjector(error_steps={1})
    cb = side.make(slots=1, faults=fi, transient_retries=2)
    req = cb.submit([1, 2, 3], max_new_tokens=4)
    cb.run_until_drained()
    assert req.status.value == "ok"
    assert cb.stats["transient_decode_errors"] == 1
    assert cb.stats.get("retries", 0) == 0
    return {"fired": fi.fired}


def s_persistent(side):
    fi = side.faults.FaultInjector(error_steps=set(range(100)),
                                   persistent_errors=True)
    cb = side.make(faults=fi, retry_budget=1, transient_retries=1)
    reqs = [cb.submit([1, 2], max_new_tokens=2) for _ in range(3)]
    done = cb.run_until_drained(max_steps=200)
    assert {r.rid for r in done} == {r.rid for r in reqs}
    assert all(r.status.value == "failed" for r in done)
    return {"fired": fi.fired}


def s_evict_recover(side):
    """A replica dies mid-flight (a torn last line in its journal); the
    recovered batcher re-admits exactly the unfinished requests; a second
    replica evicts everything, and recovery re-admits the evicted."""
    jp = side.journal("crash.jsonl")
    cb = side.make(slots=1, journal_path=jp)
    reqs = [cb.submit([i + 1, i + 2], max_new_tokens=2) for i in range(4)]
    for _ in range(4):
        cb.step()
    before = set(cb.terminal)
    cb.journal.close()
    with open(jp, "a") as f:
        f.write('{"ev": "terminal", "rid"')
    cb2 = side.recover(journal_path=jp, slots=1)
    replayed = [r.rid for r in cb2.queue]
    assert replayed == [r.rid for r in reqs if r.rid not in before]
    cb2.run_until_drained()
    cb2.journal.close()
    assert side.sched.RequestJournal.unfinished(jp) == []
    jp2 = side.journal("evict.jsonl")
    cb3 = side.make(slots=1, journal_path=jp2)
    r0 = cb3.submit([1, 2], max_new_tokens=2)
    r1 = cb3.submit([3, 4], max_new_tokens=2)
    cb3.step()
    evicted = cb3.evict_all()
    assert [r.rid for r in evicted] == [r0.rid, r1.rid]
    assert all(r.status.value == "evicted" for r in evicted)
    assert not cb3.queue and all(s.free for s in cb3.slots)
    cb3.journal.close()
    cb4 = side.recover(journal_path=jp2, slots=1)
    assert [r.rid for r in cb4.queue] == [r0.rid, r1.rid]
    assert all(r.status.value == "ok" for r in cb4.run_until_drained())
    cb4.journal.close()
    return {"replayed": replayed}


def s_degradation(side):
    """The WL walks the ladder one level at a time under pressure and back
    after the drain, the same in two runs (test_serve_robustness.py's
    degradation case); nothing is captured on the CPU."""
    traces = []
    for _ in range(2):
        pol = side.policy.PrecisionPolicy(levels=LEVELS, high_watermark=3,
                                          low_watermark=1, patience=2)
        cb = side.make(slots=1, policy=pol)
        for _ in range(6):
            cb.submit([1, 2, 3], max_new_tokens=6)
        done = cb.run_until_drained()
        assert all(r.status.value == "ok" for r in done)
        traces.append(cb.wl_trace)
    assert traces[0] == traces[1]
    assert traces[0][0] == 8 and traces[0][-1] == 8 and min(traces[0]) == 4
    assert cb.stats["precision_switches"] >= 2
    if not side.ref:
        assert cb.decode_captures == 0 and not cb._graphs
    return {}


def s_flood(side):
    """test_serve_robustness.py's whole contract at once: a flood with
    seeded faults, tight deadlines and a bounded queue; every rid reaches
    exactly one terminal status and the stats add up."""
    fi = side.faults.FaultInjector.seeded(3, steps=400, slots=2,
                                          nan_rate=0.08, error_rate=0.05)
    now = [0.0]

    def clock():
        now[0] += 0.01
        return now[0]

    cb = side.make(max_queue=6, retry_budget=1, faults=fi, clock=clock,
                   journal_path=side.journal("flood.jsonl"))
    reqs = [cb.submit([i + 1, i + 2], max_new_tokens=3,
                      timeout=0.5 if i % 5 == 4 else None)
            for i in range(14)]
    cb.run_until_drained(max_steps=400)
    assert set(cb.terminal) == {r.rid for r in reqs}
    terminal = [s.value for s in side.sched.TERMINAL]
    assert sum(cb.stats[s] for s in terminal) == len(reqs)
    assert cb.stats["submitted"] == len(reqs)
    ok = next(r for r in reqs if r.status.value == "ok")
    with pytest.raises(AssertionError):
        cb._finish(ok, side.Status.FAILED, "again")
    cb.journal.close()
    return {"fired": fi.fired}


def s_temperature(side):
    """Temperature rows draw under the reference's keys:
    fold_in(fold_in(PRNGKey(seed), step), slot), beside a greedy row."""
    out = []
    for seed in (0, 5):
        cb = side.make(seed=seed)
        a = cb.submit([4, 8, 15], max_new_tokens=6, temperature=0.8)
        b = cb.submit([16, 23, 42], max_new_tokens=6)
        c = cb.submit([7, 7], max_new_tokens=5, temperature=1.3)
        cb.run_until_drained()
        out.append([r.status.value for r in (a, b, c)])
    return {"statuses": out}


SCENARIOS = {f.__name__[2:]: f for f in (
    s_engine, s_staggered, s_isolation, s_admission, s_deadlines,
    s_drain_timeout, s_nan_retry, s_retry_exhausted, s_transient,
    s_persistent, s_evict_recover, s_degradation, s_flood, s_temperature)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batcher_matches_reference(trained, tmp_path, name):
    ref, port = _Side(trained, True, tmp_path), _Side(trained, False,
                                                      tmp_path)
    want = SCENARIOS[name](ref)
    got = SCENARIOS[name](port)
    assert got == want
    assert len(port.made) == len(ref.made)
    for i, (rcb, pcb) in enumerate(zip(ref.made, port.made)):
        _same_batcher(rcb, pcb, ref.margins[i])
    # the two packages' journals are equal line for line
    for f in sorted(ref.dir.iterdir()):
        assert (port.dir / f.name).read_text() == f.read_text(), f.name


def test_journal_lines_parse_as_the_references(trained, tmp_path):
    """Every event the port journals has the reference's keys in its
    order."""
    side = _Side(trained, False, tmp_path)
    cb = side.make(journal_path=side.journal("j.jsonl"))
    cb.submit([1, 2], max_new_tokens=2, eos_id=3, timeout=9.0)
    cb.run_until_drained()
    cb.journal.close()
    lines = [json.loads(x) for x in
             open(side.journal("j.jsonl")).read().splitlines()]
    assert [list(e) for e in lines] == [
        ["ev", "rid", "prompt", "max_new_tokens", "temperature", "eos_id",
         "deadline", "submit_time"],
        ["ev", "rid", "status", "reason", "output"]]


def test_launcher_continuous_runs_on_cpu(tmp_path, capsys):
    jp = str(tmp_path / "serve.jsonl")
    assert serve_launcher.main([
        "--arch", "tiny", "--smoke", "--device", "cpu", "--continuous",
        "--requests", "6", "--tokens", "5", "--max-new", "3",
        "--journal", jp, "--override", "serve.max_queue=4",
        "--override", "serve.degrade_high_watermark=3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] stats:" in out and "WL trace: start=8" in out
    assert "'rejected': 2" in out and "ok: 4" in out
    assert "0 decode graphs" in out
    assert len(open(jp).read().splitlines()) == 12


def test_batcher_pins_its_device(trained):
    t = trained
    with pytest.raises(ValueError, match="lies on"):
        scheduler.ContinuousBatcher(t["cfg"], t["tp"], t["ta"],
                                    device="meta")
