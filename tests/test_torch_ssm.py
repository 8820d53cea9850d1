"""The mamba2 SSD block of the port (``repro_torch/models/ssm.py``) against
the JAX reference (``repro/models/ssm.py``) on the CPU, from the same
numpy inputs and the reference's own params: the chunked scan in f32 (a
sequence that fills its chunks, one padded to the chunk, and invariance to
the chunk size), the O(1) decode step by step against the reference's
recurrence, the prefill's handoff to decode at the layer and through the
whole smoke model, the reference's short-prompt fault (a prefill shorter
than the conv's window less one) raised by name, and the gradient of the
masked decay where the reference's overflows.

Tolerances: the f32 scan normwise within 1e-5 (sums taken in other
orders); decode states within 1e-4 normwise; logits of the bf16 model
within 2^-5 of the reference's largest logit.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402

ARCH = "mamba2-780m"
SCAN_RTOL = 1e-5
STATE_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normwise(got, want, rtol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.linalg.norm((got - want).ravel()))
    assert err <= rtol * float(np.linalg.norm(want.ravel())), (what, err)


def _scan_inputs(seed, b, s, h, p, n):
    """x, dt (softplus of normals, as the block makes it), a_log, B, C and
    d_skip, f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, s, h, p)).astype(f),
            np.logaddexp(rng.normal(-1.0, 1.0, (b, s, h)), 0).astype(f),
            rng.normal(0, 0.5, (h,)).astype(f),
            rng.normal(size=(b, s, n)).astype(f),
            rng.normal(size=(b, s, n)).astype(f),
            rng.normal(1.0, 0.2, (h,)).astype(f))


@pytest.mark.parametrize("s,chunk", [(16, 8), (13, 8), (24, 64)],
                         ids=["chunk-multiple", "padded", "one-chunk"])
def test_ssd_chunked_matches_the_reference(s, chunk):
    args = _scan_inputs(s, 2, s, 3, 4, 5)
    jy, jh = jax_ssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, th = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert ty.dtype == torch.float32 and th.shape == (2, 3, 4, 5)
    _normwise(ty.numpy(), jy, SCAN_RTOL, "y")
    _normwise(th.numpy(), jh, SCAN_RTOL, "h_final")


def _ref_apply(cfg, **kw):
    """The reference's block, jitted (its eager ops compile one by one)."""
    return jax.jit(functools.partial(jax_ssm.apply, cfg=cfg, **kw))


def _layer(cfg, seed=1):
    """Layer 0 of the reference's stacked init, as numpy and as the
    port's tensors."""
    jp = jax.tree.map(lambda a: np.asarray(a[0]), jax_ssm.init_layer(
        jax.random.PRNGKey(seed), cfg, 1))
    return jp, interop.params_from_numpy(jp, "cpu")


@pytest.mark.parametrize("s", [5, 8, 13, 16, 24])
def test_ssd_block_is_invariant_to_the_chunk(s):
    """The block at chunks 4, 8 and 64 (pads included) agrees with the
    reference's block at the same chunk, and with itself across chunks
    (``tests/test_models.py``'s bound)."""
    cfg = get_smoke_config(ARCH).model
    jp, tp = _layer(cfg)
    x = np.random.default_rng(s).normal(size=(1, s, cfg.d_model)).astype(
        np.float32)
    outs = []
    for chunk in (4, 8, 64):
        c = dataclasses.replace(cfg, ssm_chunk=chunk)
        got = ssm.apply(tp, torch.from_numpy(x), c).numpy()
        want = _ref_apply(c)(jp, x)
        _normwise(got, want, SCAN_RTOL, f"chunk {chunk}")
        outs.append(got)
    for o in outs[1:]:
        assert float(np.max(np.abs(o - outs[0]))) < 1e-4


def test_decode_steps_match_the_reference_recurrence():
    """f32 inputs: 7 tokens prefilled (``return_state``), then each of the
    next 9 decoded one at a time, in both packages from the same cache.
    The port's cache is written in place and returned; every step's output
    and state within 1e-4 normwise of the reference's, and the recurrent
    states equal the chunked scan's final state."""
    cfg = get_smoke_config(ARCH).model
    jp, tp = _layer(cfg)
    jpj = jax.tree.map(jnp.asarray, jp)
    B, S, P = 2, 16, 7
    x = np.random.default_rng(5).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    jy, jc = _ref_apply(cfg, return_state=True)(jpj, x[:, :P])
    ty, tc = ssm.apply(tp, torch.from_numpy(x[:, :P]), cfg, return_state=True)
    _normwise(ty.numpy(), jy, SCAN_RTOL, "prefill")
    for n in ("conv", "ssm"):
        assert tc[n].shape == jc[n].shape
        _normwise(tc[n].numpy(), jc[n], STATE_RTOL, f"prefill {n}")
    tc = {n: t.clone() for n, t in tc.items()}
    jdecode = jax.jit(functools.partial(jax_ssm.apply_decode, cfg=cfg))
    for t in range(P, S):
        jy, jc = jdecode(jpj, x[:, t:t + 1], cache=jc)
        ty, out = ssm.apply_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg,
                                   tc)
        assert out is tc
        _normwise(ty.numpy(), jy, STATE_RTOL, f"decode {t}")
        for n in ("conv", "ssm"):
            _normwise(tc[n].numpy(), jc[n], STATE_RTOL, f"decode {t} {n}")
    _, full = ssm.apply(tp, torch.from_numpy(x), cfg, return_state=True)
    _normwise(tc["ssm"].numpy(), full["ssm"].numpy(), STATE_RTOL,
              "recurrent vs chunked state")


def _compiled(fn, *args):
    """``fn`` jitted and compiled without XLA's excess precision, so that
    its bf16 intermediates round where the port's do."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def test_model_prefill_hands_off_to_decode_as_the_reference():
    """The mamba2 smoke model in bf16 from the reference's params: the
    prefill of 11 tokens, then 5 decode steps of the same fed tokens, in
    both packages (the reference's compiled without excess precision).
    Logits within 2^-5 of the reference's largest; each layer's SSM state
    within 1e-4 normwise, the conv windows within one bf16 ulp of their
    largest value."""
    jcfg = jax_get_smoke(ARCH)
    cfg = get_smoke_config(ARCH)
    jp = jax_transformer.init_params(jax.random.PRNGKey(2), jcfg.model)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    B, S, NEW = 2, 11, 5
    toks = np.random.default_rng(3).integers(
        0, cfg.model.vocab_size, (B, S + NEW)).astype(np.int32)
    prompt = jnp.asarray(toks[:, :S])
    jlog, jc = _compiled(lambda p, t: jax_transformer.prefill(
        p, jcfg.model, t), jp, prompt)(jp, prompt)
    jdecode = _compiled(lambda p, tok, c, t: jax_transformer.decode_step(
        p, jcfg.model, tok, c, t), jp, prompt[:, 0], jc, jnp.int32(S))
    tlog, tc = transformer.prefill(tp, cfg.model, torch.from_numpy(toks[:, :S]))

    def snap(c):           # the port's caches are updated in place
        return {n: t.clone() for n, t in c["s0_mamba"].items()}

    steps = [(tlog, jlog, snap(tc), jc["s0_mamba"])]
    for i in range(NEW):
        tok = toks[:, S + i]
        jlog, jc = jdecode(jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        tlog, tc = transformer.decode_step(
            tp, cfg.model, torch.from_numpy(tok), tc, S + i)
        steps.append((tlog, jlog, snap(tc), jc["s0_mamba"]))
    for i, (tlog, jlog, tc, jc) in enumerate(steps):
        jlog = np.asarray(jlog)
        tol = 2.0 ** -5 * float(np.abs(jlog).max())
        np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0, atol=tol,
                                   err_msg=f"step {i}")
        got, want = tc, jc
        assert got["conv"].dtype == torch.bfloat16
        assert got["ssm"].shape == want["ssm"].shape == (
            cfg.model.num_layers, B, 8, 16, 16)
        _normwise(got["ssm"].numpy(), want["ssm"], STATE_RTOL, f"ssm {i}")
        conv = np.asarray(want["conv"], np.float32)
        np.testing.assert_allclose(
            got["conv"].float().numpy(), conv, rtol=0,
            atol=2.0 ** -8 * float(np.abs(conv).max()), err_msg=f"conv {i}")


def test_prefill_shorter_than_the_conv_window_raises():
    """A 2-token prompt: the reference's conv cache comes out (B, 1, C)
    where decode needs (B, kw − 1, C); the port raises instead. Three
    tokens, the shortest valid prompt, give the reference's cache."""
    cfg = get_smoke_config(ARCH).model
    jp, tp = _layer(cfg)
    x = np.random.default_rng(7).normal(size=(2, 3, cfg.d_model)).astype(
        np.float32)
    ref = _ref_apply(cfg, return_state=True)
    _, jc = ref(jp, x[:, :2])
    assert jc["conv"].shape[1] != cfg.ssm_conv_width - 1
    with pytest.raises(ValueError, match="at least 3 tokens"):
        ssm.apply(tp, torch.from_numpy(x[:, :2]), cfg, return_state=True)
    small = dataclasses.replace(cfg, num_layers=1)
    params = transformer.init_params(0, small, device="cpu")
    with pytest.raises(ValueError, match="at least 3 tokens"):
        transformer.prefill(params, small,
                            torch.zeros((1, 2), dtype=torch.int32))
    _, tc = ssm.apply(tp, torch.from_numpy(x), cfg, return_state=True)
    _, jc = ref(jp, x)
    assert tc["conv"].shape == jc["conv"].shape == (
        2, 3, cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state)
    _normwise(tc["conv"].numpy(), jc["conv"], SCAN_RTOL, "conv")


def test_masked_decay_keeps_the_gradient_finite():
    """dt large enough that a chunk's sum of dt passes f32's exp range
    above the diagonal (here 16 positions of dt ≈ 9): the reference's
    ``where(causal, exp(rel), 0)`` gives NaN gradients there, as it does
    at full width (chunk 256, dt near its initial 0.31); the port's
    masked exp gives finite ones. With small dt both agree within 1e-5
    normwise, gradients included."""
    for dt_mean, overflows in ((9.0, True), (0.3, False)):
        x, dt, a_log, B, C, d_skip = _scan_inputs(11, 1, 16, 2, 3, 4)
        dt = np.full_like(dt, dt_mean)

        def jloss(a_log, dt):
            y, h = jax_ssm.ssd_chunked(jnp.asarray(x), dt, a_log,
                                       jnp.asarray(B), jnp.asarray(C),
                                       jnp.asarray(d_skip), 16)
            return jnp.sum(y) + jnp.sum(h)

        jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a_log),
                                             jnp.asarray(dt))
        ta = torch.from_numpy(a_log).requires_grad_()
        tdt = torch.from_numpy(dt).requires_grad_()
        y, h = ssm.ssd_chunked(torch.from_numpy(x), tdt, ta,
                               torch.from_numpy(B), torch.from_numpy(C),
                               torch.from_numpy(d_skip), 16)
        tg = torch.autograd.grad(y.sum() + h.sum(), (ta, tdt))
        assert all(bool(torch.isfinite(g).all()) for g in tg)
        ref_nan = any(bool(jnp.isnan(g).any()) for g in jg)
        assert ref_nan == overflows
        if not overflows:
            for g, w, name in zip(tg, jg, ("a_log", "dt")):
                _normwise(g.numpy(), w, SCAN_RTOL, name)
