"""The port's EDF-ladder counts (the plain version of its CUDA kernel) bit
for bit against the JAX package's kernel in interpret mode
(``repro.kernels.ops.edf_ladder_hists(use_pallas=True)``) and its jnp
oracle (``ref_edf_ladder_hists``), at the ragged sizes, resolutions and
pathological values the contract names, one layer per call and batched.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fixed_point as jax_fxp  # noqa: E402
from repro.core import pushdown as jax_pushdown  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import pushdown  # noqa: E402
from repro_torch.kernels import edf_ladder, ops  # noqa: E402

LADDER = pushdown.WL_LADDER
R_UPR = 150


def _fls(w):
    """The range-derived FLs PushDown gives each rung (jnp, as the
    reference computes them)."""
    amax = jnp.max(jnp.abs(jnp.asarray(w)))
    return jax_fxp.fl_for_wl(amax, jnp.asarray(LADDER, jnp.int32))


def _counts(w, fls, r):
    """(interpret-mode kernel, jnp oracle, port) counts of one layer."""
    jw, jr = jnp.asarray(w), jnp.int32(r)
    kern = np.asarray(jops.edf_ladder_hists(jw, fls, jr, wl_ladder=LADDER,
                                            r_upr=R_UPR, use_pallas=True))
    oracle = np.asarray(jref.ref_edf_ladder_hists(jw, fls, jr,
                                                  wl_ladder=LADDER,
                                                  r_upr=R_UPR))
    port = ops.edf_ladder_hists(
        torch.from_numpy(w).reshape(1, -1),
        torch.from_numpy(np.array(fls)).reshape(1, -1), [r],
        wl_ladder=LADDER, r_upr=R_UPR, use_pallas=True).numpy()
    return kern, oracle, port[0]


def _gaussian(n, seed):
    return np.random.default_rng(seed).normal(0, 0.05, n).astype(np.float32)


@pytest.mark.parametrize("r", [50, 150])
@pytest.mark.parametrize("n", [1, 127, 4096, 65536 + 5])
def test_counts_bit_equal(n, r):
    w = _gaussian(n, n + r)
    kern, oracle, port = _counts(w, _fls(w), r)
    assert port.dtype == np.float32 and port.shape == (1 + len(LADDER), R_UPR)
    np.testing.assert_array_equal(port, kern)
    np.testing.assert_array_equal(port, oracle)
    assert (port.sum(axis=1) == n).all() and not port[:, r:].any()


@pytest.mark.parametrize("r", [50, 150])
def test_counts_at_hand_set_fls_bit_equal(r):
    """FLs far from the range-derived ones: words that clip at qmax,
    rows collapsed into few bins, WL 32's qmax of 2^31."""
    w = _gaussian(3000, r) * 40.0
    fls = jnp.asarray(np.arange(len(LADDER)) % 7 * 5 - 6, jnp.int32)
    kern, oracle, port = _counts(w, fls, r)
    np.testing.assert_array_equal(port, kern)
    np.testing.assert_array_equal(port, oracle)


def _patho(name):
    return {
        "signed_zeros": np.array([0.0, -0.0] * 320, np.float32),
        "denormals": np.array([1e-42, -3e-41, 5e-44, -1e-45] * 160,
                              np.float32),
        "inf_adjacent": np.array([3.3e38, -3.3e38, 1e30, -1e25] * 160,
                                 np.float32),
        "all_equal": np.full((640,), 0.3, np.float32),
        "all_equal_negative": np.full((640,), -1.75, np.float32),
        "mixed_extremes": np.array([0.0, -0.0, 1e-42, 3.3e38, -3.3e38,
                                    0.5, -0.5, 1.0] * 80, np.float32),
    }[name]


@pytest.mark.parametrize("r", [50, 150])
@pytest.mark.parametrize("case", ["signed_zeros", "denormals",
                                  "inf_adjacent", "all_equal",
                                  "all_equal_negative", "mixed_extremes"])
def test_pathological_counts_bit_equal(case, r):
    """Bit-equal to the interpret-mode kernel everywhere. Where max − min
    overflows to inf (inf_adjacent, mixed_extremes) the bin of an element
    at the max is NaN: the kernel counts it in no row, and so does the
    port, while the reference's jnp oracle converts the NaN to bin 0 and
    counts it there (ROADMAP.md, Queue 3); everywhere else all three
    agree."""
    w = _patho(case)
    fls = _fls(w)
    kern, oracle, port = _counts(w, fls, r)
    np.testing.assert_array_equal(port, kern)
    wf = w.astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        span = np.maximum(wf.max() - wf.min(), np.float32(1e-12))
        nan_bins = np.isnan((wf - wf.min()) / span)
    if not nan_bins.any():
        np.testing.assert_array_equal(port, oracle)
    else:
        # the oracle's extra counts are the NaN bins, all in bin 0
        extra = oracle - port
        assert (extra[:, 1:] == 0).all()
        assert extra[0, 0] == nan_bins.sum()
        assert (oracle.sum(axis=1) == w.size).all()


def test_batched_layers_equal_one_call_per_layer():
    """One call over (L, n) with a per-layer r and per-layer FLs gives each
    layer's own counts, as the reference's vmap over layers does."""
    w = np.stack([_gaussian(5000, s) * (1 + s) for s in range(3)])
    rs = np.array([50, 97, 150], np.int32)
    fls = np.stack([np.asarray(_fls(w[l])) for l in range(3)])
    got = ops.edf_ladder_hists(torch.from_numpy(w), torch.from_numpy(fls),
                               torch.from_numpy(rs), wl_ladder=LADDER,
                               r_upr=R_UPR, use_pallas=True).numpy()
    assert got.shape == (3, 1 + len(LADDER), R_UPR)
    for l in range(3):
        want = np.asarray(jops.edf_ladder_hists(
            jnp.asarray(w[l]), jnp.asarray(fls[l]), jnp.int32(rs[l]),
            wl_ladder=LADDER, r_upr=R_UPR, use_pallas=True))
        np.testing.assert_array_equal(got[l], want, err_msg=f"layer {l}")
    # without use_pallas: the plain version on any device, same counts
    plain = ops.edf_ladder_hists(torch.from_numpy(w), torch.from_numpy(fls),
                                 torch.from_numpy(rs), wl_ladder=LADDER,
                                 r_upr=R_UPR).numpy()
    np.testing.assert_array_equal(plain, got)
    assert edf_ladder.edf_ladder_hists.launches == 0   # CPU: no launch


def test_ladder_is_the_reference_ladder():
    assert pushdown.WL_LADDER == jax_pushdown.WL_LADDER
