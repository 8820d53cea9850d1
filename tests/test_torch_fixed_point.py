"""Port parity: fixed-point words and the serving quantize.

The same numpy inputs go through ``repro`` (JAX) and ``repro_torch``; every
check here is bit-exact, because the reference pins these bits (exponent-bit
``pow2i``, round-half-even RTN, the bf16 2^-FL scale).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import load_config as jax_load_config  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.core import fixed_point as jax_fxp  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.core import controller, fixed_point as fxp  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

PACKED = ["quant.container_dtype=int8_packed", "quant.use_pallas=true"]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def test_pow2i_bit_exact():
    e = np.arange(-140, 141, dtype=np.int32)
    want = np.asarray(jax_fxp.pow2i(jnp.asarray(e)))
    got = fxp.pow2i(torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fl", [0, 3, 7, 12])
def test_quantize_int8_rtn_bit_exact_with_ties(fl):
    rng = np.random.default_rng(fl)
    ties = (np.arange(-300, 300) + 0.5) / 2.0 ** fl       # exact half-way words
    w = np.concatenate([ties, rng.normal(0, 4.0 / 2 ** fl, 4096)]
                       ).astype(np.float32)
    wq, ws = jax_fxp.quantize_int8(jnp.asarray(w), jnp.int32(fl))
    q, s = fxp.quantize_int8(torch.from_numpy(w), fl)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(ws))


def test_fxp_bounds_and_fl_for_wl_match():
    wl = np.arange(2, 33, dtype=np.int32)
    for a, b in zip(fxp.fxp_bounds(torch.from_numpy(wl)),
                    jax_fxp.fxp_bounds(jnp.asarray(wl))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    amax = np.array([1e-13, 0.01, 0.49, 1.0, 1.5, 7.9, 300.0], np.float32)
    np.testing.assert_array_equal(
        fxp.fl_for_wl(torch.from_numpy(amax), 8).numpy(),
        np.asarray(jax_fxp.fl_for_wl(jnp.asarray(amax), 8)))


def test_serving_quantize_bit_exact():
    """q8 and sc of the packed serving tree, on JAX-initialised tiny params
    with per-layer FL drawn in [5, 10] (FL 10 clips some words)."""
    jcfg = jax_load_config("tiny", overrides=PACKED)
    cfg = load_config("tiny", overrides=PACKED)
    jp = jax_transformer.init_params(jax.random.PRNGKey(3), jcfg.model)
    js = jax_controller.init_adapt_state(jp, jcfg.quant)
    rng = np.random.default_rng(0)
    for ts in js["tensors"].values():
        ts["fl"] = jnp.asarray(rng.integers(5, 11, ts["fl"].shape), jnp.int32)
    want = jax.tree.map(np.asarray, jax_engine.quantize_for_serving(
        jp, js, jcfg.quant))
    got = engine.quantize_for_serving(
        interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        interop.adapt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu"),
        cfg.quant)
    flat_want = dict(controller.flatten_with_path(want))
    flat_got = dict(controller.flatten_with_path(got))
    assert flat_got.keys() == flat_want.keys()
    clipped = 0
    for path, w in flat_want.items():
        g = flat_got[path]
        assert tuple(g.shape) == w.shape, path
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
            clipped += int((np.abs(w.astype(np.int32)) >= 127).sum())
        else:           # bf16 leaves: sc, wref (zeros), norms
            np.testing.assert_array_equal(_bits(g.contiguous().view(
                torch.int16).numpy()), _bits(w), err_msg=path)
    assert clipped > 0          # the FL draw reached the clip


def test_dequant_and_unpack_keep_dense():
    q8 = torch.tensor([[-128, 3], [127, -1]], dtype=torch.int8)
    sc = fxp.pow2i(-4).to(torch.bfloat16)
    leaf = {"q8": q8, "sc": sc, "wref": torch.zeros((), dtype=torch.bfloat16
                                                   ).expand(2, 2)}
    want = np.asarray(jax_fxp.dequant_packed(
        jnp.asarray(q8.numpy()), jnp.asarray(sc.float().numpy(), jnp.bfloat16),
        jnp.zeros((2, 2), jnp.bfloat16)), np.float32)
    tree = fxp.unpack_tree({"a": {"wq": leaf, "emb": leaf}}, keep_dense=True)
    assert fxp.is_packed(tree["a"]["wq"])
    np.testing.assert_array_equal(tree["a"]["emb"].float().numpy(), want)
