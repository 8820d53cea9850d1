"""The continuous batcher's plain-Python parts against the reference's:
the AdaBits precision policy, the seeded fault schedule and the request
journal, which crosses between the two packages both ways. No model runs
here; ``corrupt_logits`` writes a torch tensor in place where the
reference returns an updated ``jnp`` copy.
"""
import json
import math

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.config import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import faults as jax_faults  # noqa: E402
from repro.serve import policy as jax_policy  # noqa: E402
from repro.serve.journal import RequestJournal as JaxJournal  # noqa: E402
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.serve import faults, policy  # noqa: E402
from repro_torch.serve.journal import RequestJournal  # noqa: E402
from repro_torch.serve.scheduler import Request, Status  # noqa: E402


def _both(**kw):
    return jax_policy.PrecisionPolicy(**kw), policy.PrecisionPolicy(**kw)


def test_policy_pinned_trace():
    """test_serve_robustness.py's hand-verified hysteresis trace."""
    ref, port = _both(levels=(8, 6, 4), high_watermark=4, low_watermark=1,
                      patience=2)
    depths = [0, 5, 5, 5, 5, 2, 0, 0, 0, 0, 5, 0]
    want = [ref.observe(d) for d in depths]
    assert want == [8, 8, 6, 6, 4, 4, 4, 6, 6, 8, 8, 8]
    assert [port.observe(d) for d in depths] == want
    assert port.wl == ref.wl == 8


def test_policy_latency_trigger():
    ref, port = _both(levels=(8, 4), high_watermark=100, low_watermark=1,
                      p95_high_ms=50.0, patience=1)
    for p in (ref, port):
        assert p.observe(0, p95_wait_ms=60.0) == 4
        assert p.observe(0, p95_wait_ms=0.0) == 8


@pytest.mark.parametrize("kw", [
    dict(levels=(4, 6, 8)), dict(levels=()), dict(levels=(8, 8, 4)),
    dict(high_watermark=2, low_watermark=2),
    dict(high_watermark=2, low_watermark=5), dict(patience=0),
    dict(patience=-3)])
def test_policy_validation_errors_are_the_references(kw):
    with pytest.raises(ValueError) as want:
        jax_policy.PrecisionPolicy(**kw)
    with pytest.raises(ValueError) as got:
        policy.PrecisionPolicy(**kw)
    assert str(got.value) == str(want.value)


def test_policy_from_config():
    kw = dict(degrade_levels=(8, 5, 3, 2), degrade_high_watermark=6,
              degrade_low_watermark=2, degrade_p95_ms=12.5,
              degrade_patience=3)
    ref = jax_policy.PrecisionPolicy.from_config(JaxServeConfig(**kw))
    port = policy.PrecisionPolicy.from_config(ServeConfig(**kw))
    assert (port.levels, port.high_watermark, port.low_watermark,
            port.p95_high_ms, port.patience) == (
        ref.levels, ref.high_watermark, ref.low_watermark, ref.p95_high_ms,
        ref.patience)


@settings(max_examples=60, deadline=None)
@given(levels=st.lists(st.integers(1, 16), min_size=1, max_size=5,
                       unique=True),
       high=st.integers(1, 10), gap=st.integers(1, 5),
       p95_high=st.sampled_from([0.0, 20.0, 75.5]),
       patience=st.integers(1, 4),
       obs=st.lists(st.tuples(st.integers(0, 14),
                              st.floats(0.0, 150.0, allow_nan=False)),
                    max_size=60))
def test_policy_traces_equal_the_references(levels, high, gap, p95_high,
                                           patience, obs):
    ref, port = _both(levels=tuple(sorted(levels, reverse=True)),
                      high_watermark=high, low_watermark=high - gap,
                      p95_high_ms=p95_high, patience=patience)
    assert [port.observe(d, w) for d, w in obs] == \
        [ref.observe(d, w) for d, w in obs]
    assert (port._idx, port._down, port._up) == (ref._idx, ref._down, ref._up)


@pytest.mark.parametrize("seed", [0, 3, 7, 12345, 2 ** 31 - 1])
@pytest.mark.parametrize("rates", [(0.2, 0.1), (0.08, 0.05), (0.0, 0.5),
                                   (1.0, 0.0)])
def test_seeded_schedule_is_the_references(seed, rates):
    kw = dict(steps=120, slots=4, nan_rate=rates[0], error_rate=rates[1])
    ref = jax_faults.FaultInjector.seeded(seed, **kw)
    port = faults.FaultInjector.seeded(seed, **kw)
    assert port.nan_steps == ref.nan_steps
    assert port._error_steps == ref._error_steps
    assert bool(port.nan_steps) == (rates[0] > 0)


def test_before_decode_matches_the_reference():
    for persistent in (False, True):
        ref = jax_faults.FaultInjector(error_steps={2, 5},
                                       persistent_errors=persistent)
        port = faults.FaultInjector(error_steps={2, 5},
                                    persistent_errors=persistent)
        for step in range(7):
            for attempt in range(3):
                raised = []
                for inj, err in ((ref, jax_faults.TransientDecodeError),
                                 (port, faults.TransientDecodeError)):
                    try:
                        inj.before_decode(step, attempt)
                        raised.append(None)
                    except err as e:
                        raised.append(str(e))
                assert raised[0] == raised[1]
        assert port.fired == ref.fired


@pytest.mark.parametrize("value", [math.nan, math.inf, -math.inf])
def test_corrupt_logits_poisons_exactly_the_scheduled_rows(value):
    inj = faults.FaultInjector(nan_steps={1: (0, 2), 3: (1,)},
                               corrupt_value=value)
    logits = torch.randn(4, 9)
    clean = logits.clone()
    assert inj.corrupt_logits(0, logits) is logits
    assert torch.equal(logits, clean)
    out = inj.corrupt_logits(1, logits)
    assert out is logits                       # in place
    bad = ~torch.isfinite(out).all(dim=-1)
    assert bad.tolist() == [True, False, True, False]
    assert torch.equal(out[[1, 3]], clean[[1, 3]])
    if math.isnan(value):
        assert torch.isnan(out[[0, 2]]).all()
    else:
        assert (out[[0, 2]] == value).all()
    assert inj.fired == [("nan", 1, (0, 2))]


# ---------------------------------------------------------------------------
# Journals


def _request(rid, status=Status.PENDING, **kw):
    kw.setdefault("prompt", [rid + 1, rid + 2])
    kw.setdefault("max_new_tokens", 3)
    req = Request(rid, **kw)
    req.status = status
    return req


def _write(journal_cls, path, events):
    j = journal_cls(str(path))
    for kind, req in events:
        (j.record_submit if kind == "submit" else j.record_terminal)(req)
    j.close()


def _events():
    """Four requests: 0 done, 1 evicted, 2 in flight, 3 failed; then 1
    re-submitted after a replay and left in flight."""
    reqs = [_request(0, eos_id=7, deadline=3.5, submit_time=0.25),
            _request(1, temperature=0.5, submit_time=0.5),
            _request(2, submit_time=0.75), _request(3, submit_time=1.0)]
    out = [("submit", r) for r in reqs]
    for r, st_, reason, output in ((reqs[0], Status.OK, "", [4, 5, 6]),
                                   (reqs[1], Status.EVICTED,
                                    "replica_shutdown", [9]),
                                   (reqs[3], Status.FAILED,
                                    "non_finite_logits", [])):
        r.status, r.reason, r.output = st_, reason, output
        out.append(("terminal", r))
    out.append(("submit", reqs[1]))
    return out


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journals_cross_packages(tmp_path, writer):
    """A journal written by either package is byte-equal to the other's for
    the same events and replays the same unfinished requests through both
    ``unfinished``."""
    paths = {}
    for name, cls in (("port", RequestJournal), ("reference", JaxJournal)):
        paths[name] = tmp_path / f"{name}.jsonl"
        _write(cls, paths[name], _events())
    assert paths["port"].read_bytes() == paths["reference"].read_bytes()
    src = str(paths[writer])
    got, want = RequestJournal.unfinished(src), JaxJournal.unfinished(src)
    assert got == want
    assert [e["rid"] for e in got] == [1, 2]
    assert got[0]["temperature"] == 0.5


def test_torn_last_line_is_skipped_and_replay_is_idempotent(tmp_path):
    path = tmp_path / "torn.jsonl"
    _write(RequestJournal, path, _events())
    with open(path, "a") as f:
        f.write('{"ev": "terminal", "rid": 2, "sta')
    for cls in (RequestJournal, JaxJournal):
        assert [e["rid"] for e in cls.unfinished(str(path))] == [1, 2]
    # a replica re-submits what it replayed: the last event per rid wins,
    # so replaying again gives the same requests
    j = RequestJournal(str(path))
    with open(path, "a") as f:
        f.write("\n")
    for ev in RequestJournal.unfinished(str(path)):
        j.record_submit(_request(ev["rid"], prompt=ev["prompt"],
                                 max_new_tokens=ev["max_new_tokens"]))
    j.close()
    for cls in (RequestJournal, JaxJournal):
        assert [e["rid"] for e in cls.unfinished(str(path))] == [1, 2]
    assert RequestJournal.unfinished(str(tmp_path / "missing.jsonl")) == []


def test_journal_event_keys_in_the_references_order(tmp_path):
    path = tmp_path / "keys.jsonl"
    _write(RequestJournal, path, _events()[:5])
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert list(lines[0]) == ["ev", "rid", "prompt", "max_new_tokens",
                              "temperature", "eos_id", "deadline",
                              "submit_time"]
    assert list(lines[4]) == ["ev", "rid", "status", "reason", "output"]
