"""The port's MuPPET baseline (``core/muppet.py``, paper §2.2) against the
reference's: the block-floating-point scale and values bit for bit (to
nearest, and stochastically with the same noise ``u``), the switch state
through a run of epochs, the current word length, and ``quantize_params``
on a ResNet20 tree at WL 8 and float32, to nearest and with the same key,
and at WL 14 to nearest: the
leaf keys hash the JAX key path's text with Python's ``hash``, which both
packages share within one process. The diversity's mean over the layers
sums floats in another order: within ``DIVERSITY_RTOL``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import muppet as jax_muppet  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import muppet, threefry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's many small torch ops run on one thread: beside other
    test processes an intra-op thread pool only waits for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# f32 sums of up to 200 ratios in torch's and XLA's orders (measured: 4
# ulps)
DIVERSITY_RTOL = 1e-6


@pytest.mark.parametrize("wl", muppet.LADDER)
def test_block_fp_matches_reference(wl):
    """Sizes 1 to 2999, magnitudes 1e-3 to 1e3, all-positive inputs among
    them (the reference's functions compiled once per size)."""
    assert muppet.LADDER == jax_muppet.LADDER
    rng = np.random.default_rng(wl)
    scale = jax.jit(jax_muppet.block_fp_scale, static_argnums=1)
    rtn = jax.jit(jax_muppet.quantize_block_fp, static_argnums=1)
    sr = jax.jit(jax_muppet.quantize_block_fp, static_argnums=1)
    for trial in range(36):
        n = (1, 2, 7, 100, 1152, 2999)[trial % 6]
        x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3)).astype(
            np.float32)
        if trial % 5 == 0:
            x = np.abs(x)                          # no negative value
        u = rng.random(n, dtype=np.float32)
        tx = torch.from_numpy(x)
        np.testing.assert_array_equal(muppet.block_fp_scale(tx, wl).numpy(),
                                      np.asarray(scale(x, wl)))
        np.testing.assert_array_equal(muppet.quantize_block_fp(tx, wl).numpy(),
                                      np.asarray(rtn(x, wl)))
        np.testing.assert_array_equal(
            muppet.quantize_block_fp(tx, wl, torch.from_numpy(u)).numpy(),
            np.asarray(sr(x, wl, u)))


def test_switch_state_matches_reference():
    """init_state, then end_of_epoch through falling and rising
    diversities: every field equal after every epoch, the level only going
    up, current_wl the reference's."""
    for threshold, needed in ((1.05, 2), (1.15, 2), (1.3, 1)):
        js = jax_muppet.init_state(4, threshold=threshold,
                                   violations_needed=needed)
        ts = muppet.init_state(4, threshold=threshold,
                               violations_needed=needed, device="cpu")
        divs = (10.0, 8.0, 6.0, 5.0, 9.0, 4.0, 3.5, 3.0, 2.5, 2.4, 2.3, 7.0,
                2.0, 1.0, 0.5, 0.3, 1e-35, 0.2)
        levels = []
        for d in divs:
            js = jax_muppet.end_of_epoch(js, jnp.float32(d))
            ts = muppet.end_of_epoch(ts, torch.tensor(d))
            assert js.keys() == ts.keys()
            for k in js:
                want = np.asarray(js[k])
                got = ts[k].numpy()
                assert got.dtype == want.dtype, k
                np.testing.assert_array_equal(got, want, err_msg=k)
            assert int(muppet.current_wl(ts)) == int(
                jax_muppet.current_wl(js))
            levels.append(int(ts["level"]))
        assert levels == sorted(levels) and levels[-1] > 0


def test_epoch_diversity_matches_reference():
    rng = np.random.default_rng(0)
    for layers in list(range(1, 25)) + [31, 64, 100, 128, 199, 200]:
        a = rng.random(layers, dtype=np.float32) * 10
        g = rng.random(layers, dtype=np.float32)
        g[0] = 0.0                                  # the 1e-30 floor
        want = float(jax_muppet.epoch_diversity(jnp.asarray(a),
                                                jnp.asarray(g)))
        got = float(muppet.epoch_diversity(torch.from_numpy(a),
                                           torch.from_numpy(g)))
        assert got == pytest.approx(want, rel=DIVERSITY_RTOL)


def test_quantize_params_matches_reference():
    jparams, _ = jax.jit(jax_cnn.init_resnet20, static_argnames=(
        "num_classes", "width"))(jax.random.PRNGKey(1), width=0.25)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    js = jax_muppet.init_state(2)
    ts = muppet.init_state(2, device="cpu")
    for level, seeds in ((0, (None, 11)), (2, (None,)),
                         (len(muppet.LADDER) - 1, (None, 11))):
        js["level"] = jnp.int32(level)
        ts["level"] = torch.tensor(level, dtype=torch.int32)
        for seed in seeds:
            want = jax_muppet.quantize_params(
                jparams, js, None if seed is None else jax.random.PRNGKey(seed))
            got = muppet.quantize_params(
                params, ts, None if seed is None else
                threefry.key_from_seed(seed))
            wflat = jax.tree_util.tree_flatten_with_path(want)[0]
            for path, w in wflat:
                t = got
                for k in path:
                    t = t[k.key]
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), np.asarray(w),
                                              err_msg=f"{level} {seed} {path}")


def test_keypath_text_is_jaxs():
    tree = {"s0b0": {"conv1": {"w": jnp.zeros((1, 1, 1, 1))}},
            "fc": jnp.zeros((2, 2))}
    texts = []
    jax.tree_util.tree_map_with_path(lambda p, _: texts.append(str(p)), tree)
    assert sorted(texts) == sorted([
        muppet._keypath_text(("s0b0", "conv1", "w")),
        muppet._keypath_text(("fc",))])
