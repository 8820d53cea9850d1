"""The port's analytical performance model (``core/perf_model.py``, paper
§4.1.2, eq. 6–9) against the reference's: every function gives the same
floats on the same synthetic telemetry, with the op counts from each
package's ``layer_madds`` of the same ResNet20 and AlexNet trees."""
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import perf_model as jax_perf_model  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro_torch.core import perf_model  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's many small torch ops run on one thread: beside other
    test processes an intra-op thread pool only waits for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ops(mod, madds, sizes, batch):
    return {k: mod.LayerOps(ops=v * batch, params=float(sizes[k]))
            for k, v in madds.items()}


def _telemetry(mod, paths, steps, rng):
    out = []
    for _ in range(steps):
        wl = {p: float(rng.randint(2, 16)) for p in paths}
        sp = {p: rng.random() for p in paths}
        lb = {p: float(rng.randint(1, 100)) for p in paths}
        r = {p: float(rng.randint(50, 150)) for p in paths}
        out.append(mod.StepTelemetry(wl=wl, sp=sp, lb=lb, r=r))
    return out


@pytest.mark.parametrize("name", ["alexnet", "resnet20"])
@pytest.mark.parametrize("width", [0.25, 1.0])
def test_perf_model_matches_reference(name, width):
    params, _ = cnn.MODELS[name][0](0, width=width, device="cpu")
    jparams = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda k: jax_cnn.MODELS[name][0](k, width=width)[0],
                       jax.random.PRNGKey(0)))
    madds, jmadds = cnn.layer_madds(params), jax_cnn.layer_madds(jparams)
    assert list(madds.items()) == list(jmadds.items())
    sizes = {}
    for path in madds:
        t = params
        for k in path.split("/"):
            t = t[k]
        sizes[path] = t.numel()
    for batch, accs, steps in ((512, 1, 7), (64, 4, 1), (16, 2, 30)):
        ops = _ops(perf_model, madds, sizes, batch)
        jops = _ops(jax_perf_model, jmadds, sizes, batch)
        tel = _telemetry(perf_model, list(madds), steps, random.Random(steps))
        jtel = _telemetry(jax_perf_model, list(madds), steps,
                          random.Random(steps))
        # a tensor the telemetry leaves out takes the defaults
        for t, jt in zip(tel, jtel):
            for field in ("wl", "sp", "lb", "r"):
                getattr(t, field).pop(next(iter(madds)))
                getattr(jt, field).pop(next(iter(madds)))
        assert perf_model.summarize(ops, tel, accs=accs, bs_ours=batch,
                                    bs_other=256) == jax_perf_model.summarize(
            jops, jtel, accs=accs, bs_ours=batch, bs_other=256)
        for fn in ("train_costs", "adapt_overhead"):
            assert getattr(perf_model, fn)(ops, tel, accs) == \
                getattr(jax_perf_model, fn)(jops, jtel, accs)
        assert perf_model.float32_costs(ops, steps, accs) == \
            jax_perf_model.float32_costs(jops, steps, accs)
        assert perf_model.inference_costs(ops, tel[-1]) == \
            jax_perf_model.inference_costs(jops, jtel[-1])
        assert perf_model.model_size(ops, tel[-1]) == \
            jax_perf_model.model_size(jops, jtel[-1])
        assert perf_model.avg_memory(ops, tel) == \
            jax_perf_model.avg_memory(jops, jtel)
        assert perf_model.speedup(3.0, 2.0, 5.0, 7.0) == \
            jax_perf_model.speedup(3.0, 2.0, 5.0, 7.0)
    assert perf_model.avg_memory(ops, []) == 0.0


def test_quantized_training_is_cheaper_than_float32():
    """At WL 8 and half the weights zero, the model predicts a training
    speedup above 1 and a final model below a fifth of the float32 size."""
    ops = {"a": perf_model.LayerOps(ops=1e9, params=1e6)}
    tel = [perf_model.StepTelemetry(wl={"a": 8.0}, sp={"a": 0.5},
                                    lb={"a": 25.0}, r={"a": 50.0})] * 10
    s = perf_model.summarize(ops, tel)
    assert s["SU_train"] > 1.0 and s["SZ"] == pytest.approx(0.125)
    assert s["MEM"] > 1.0 and s["avg_wl"] == 8.0 and s["avg_sp"] == 0.5
