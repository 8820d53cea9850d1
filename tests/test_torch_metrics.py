"""The port's metrics and fault tolerance against the reference's:
``wl_summary`` and the ``MetricsLogger`` records of the same controller
snapshot (the port's, after a switch), the loop's JSONL streams, and
``StepWatchdog``, ``retry``, ``Heartbeat`` and ``PreemptionGuard`` given
the same inputs.
"""
import os
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.train import fault_tolerance as jax_ft  # noqa: E402
from repro.train import metrics as jax_metrics  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402
from repro_torch.train import metrics, train_loop  # noqa: E402

SMALL = ["train.global_batch=2", "train.seq_len=16", "quant.init_fl=8",
         "quant.container_dtype=int8_packed", "quant.use_pallas=true",
         "train.adapt_interval=2", "quant.lb_lwr=2"]


@pytest.fixture(scope="module")
def snapshot():
    """The controller snapshot of the port after two steps and a switch."""
    cfg = load_config("tiny", overrides=SMALL)
    state, _ = train_loop.train(cfg, steps=2, device="cpu",
                                log=lambda s: None)
    return controller.snapshot(state["adapt"])


def _strip_time(records):
    for r in records:
        assert isinstance(r.pop("t"), float)
    return records


def test_wl_summary_matches_the_reference(snapshot):
    assert metrics.wl_summary(snapshot) == jax_metrics.wl_summary(snapshot)
    assert metrics.wl_summary({}) == jax_metrics.wl_summary({}) == {}
    flat = {"a": {"wl": np.array([8, 16]), "sp": np.array([1.0, 0.5])},
            "b": {"wl": np.array(12), "sp": np.array(0.8)}}
    s = metrics.wl_summary(flat)
    assert s == jax_metrics.wl_summary(flat)
    assert s["wl_min"] == 8 and s["wl_max"] == 16 and s["num_tensors"] == 2
    assert abs(s["size_units"] - (8 * 1.0 + 16 * 0.5 + 12 * 0.8)) < 1e-5


def test_logger_records_match_the_reference(snapshot, tmp_path):
    """The same calls on both loggers write the same files, timestamps
    aside."""
    paths = {}
    for name, mod in (("port", metrics), ("ref", jax_metrics)):
        logger = mod.MetricsLogger(str(tmp_path / name), run_name="r",
                                   flush_every=1)
        logger.log_step(3, {"loss": np.float32(2.5), "lr": 0.05}, dt=0.25)
        logger.log_step(4, {"loss": torch.tensor(2.25)})
        logger.log_switch(4, snapshot)
        logger.log_event("finished", steps=4)
        logger.close()
        paths[name] = (logger.path, logger.switch_path)
        assert os.path.basename(logger.path) == "r.metrics.jsonl"
        assert os.path.basename(logger.switch_path) == "r.switches.jsonl"
    for got, want in zip(*paths.values()):
        assert _strip_time(metrics.read_jsonl(got)) == _strip_time(
            jax_metrics.read_jsonl(want))
    switch = metrics.read_jsonl(paths["port"][1])[0]
    assert switch["kind"] == "switch" and switch["step"] == 4
    assert set(switch["tensors"]) == set(snapshot)


def test_the_loop_streams_steps_and_switches(tmp_path):
    cfg = load_config("tiny", overrides=SMALL + ["train.log_every=2"])
    logger = metrics.MetricsLogger(str(tmp_path), run_name="t", flush_every=1)
    telemetry = []
    train_loop.train(cfg, steps=4, device="cpu", log=lambda s: None,
                     metrics_logger=logger, telemetry=telemetry)
    logger.log_event("shutdown", reason="test")
    logger.close()
    steps = metrics.read_jsonl(logger.path)
    switches = metrics.read_jsonl(logger.switch_path)
    assert [r["step"] for r in steps if r["kind"] == "step"] == [2, 4]
    assert all("loss" in r and "dt_s" in r for r in steps[:-1])
    assert steps[-1]["kind"] == "shutdown"
    assert [s["step"] for s in switches] == [2, 4] and len(telemetry) == 2
    assert all(2 <= s["wl_min"] <= s["wl_max"] <= 32 for s in switches)
    assert switches[-1] == {**switches[-1], **metrics.wl_summary(
        telemetry[-1])}


def test_watchdog_flags_as_the_reference(tmp_path):
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 5.0, 1.0, 4.0, 4.5, 0.95]
    seen = {"port": [], "ref": []}
    dogs = {name: mod.StepWatchdog(factor=3.0, window=4, min_samples=3,
                                   on_straggler=lambda s, dt, m, n=name:
                                   seen[n].append((s, dt, m)))
            for name, mod in (("port", ft), ("ref", jax_ft))}
    flags = {name: [d.observe(i, t) for i, t in enumerate(times)]
             for name, d in dogs.items()}
    assert flags["port"] == flags["ref"] and any(flags["port"])
    assert seen["port"] == seen["ref"]
    assert dogs["port"].events == dogs["ref"].events
    assert dogs["port"].times == dogs["ref"].times
    strict = ft.StepWatchdog(factor=2.0, min_samples=2, max_consecutive=2)
    for i, t in enumerate([1.0, 1.0, 3.0]):
        strict.observe(i, t)
    with pytest.raises(ft.StragglerEvent, match="2 consecutive"):
        strict.observe(3, 3.0)


def test_retry_backs_off_then_raises():
    for mod in (ft, jax_ft):
        calls, retries = [], []

        def flaky(x):
            calls.append(x)
            if len(calls) < 3:
                raise IOError("transient")
            return x * 2

        assert mod.retry(flaky, 21, attempts=3, base_delay=0.0,
                         on_retry=lambda i, e: retries.append(i)) == 42
        assert retries == [0, 1] and calls == [21] * 3

        def broken():
            raise OSError("down")

        with pytest.raises(OSError, match="down"):
            mod.retry(broken, attempts=2, base_delay=0.0)
        with pytest.raises(ValueError):
            mod.retry(lambda: int("x"), attempts=5, base_delay=0.0)


def test_heartbeat_emits_on_its_interval():
    for mod in (ft, jax_ft):
        lines = []
        hb = mod.Heartbeat(interval=0.0, emit=lines.append)
        hb.beat(1, extra="loss=1.0")
        hb.beat(2)
        assert [line.split(" t=")[0] for line in lines] == [
            "[heartbeat] step=1", "[heartbeat] step=2"]
        assert lines[0].endswith(" loss=1.0")
        hb.interval = 3600.0          # the next beat is inside the interval
        hb.beat(3)
        assert len(lines) == 2


def test_preemption_guard_flips_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    with ft.PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) == before
    with ft.PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested
