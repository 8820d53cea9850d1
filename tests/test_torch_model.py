"""Port parity for the whole serving slice on ``tiny``: forward, prefill,
one decode step and greedy ``Engine.generate``, on the same packed words,
against the JAX reference with ``use_pallas=True`` (interpret mode).

Tolerance: activations are bf16 after the embedding, as in the reference,
and the two frameworks round f32 sums taken in different orders to bf16 at
every layer, so a value may land one bf16 ulp away and carry that through
the remaining layers. Logits are held within 2^-5 of the reference's
largest logit (four bf16 ulps there).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import load_config as jax_load_config  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

# init_fl=8 puts tiny's TNVS weights (|w| <= sqrt(3/64) ≈ 0.22) in about
# ±55: words with many distinct values, none clipped.
OVERRIDES = ["quant.container_dtype=int8_packed", "quant.use_pallas=true",
             "quant.init_fl=8"]
B, S, NEW = 2, 12, 4


def _tol(ref: np.ndarray) -> float:
    return 2.0 ** -5 * float(np.abs(ref).max())


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_load_config("tiny", overrides=OVERRIDES)
    cfg = load_config("tiny", overrides=OVERRIDES)
    jp = jax_transformer.init_params(jax.random.PRNGKey(0), jcfg.model)
    js = jax_controller.init_adapt_state(jp, jcfg.quant)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = interop.adapt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.model.vocab_size, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, js=js, tp=tp, ts=ts,
                jq=jax_engine.quantize_for_serving(jp, js, jcfg.quant),
                tq=engine.quantize_for_serving(tp, ts, cfg.quant),
                tokens=tokens)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_matches_reference(setup, use_pallas):
    s = setup
    want = np.asarray(jax_transformer.forward(
        s["jq"], s["jcfg"].model, tokens=jnp.asarray(s["tokens"]),
        use_pallas=use_pallas))
    got = transformer.forward(s["tq"], s["cfg"].model,
                              tokens=torch.from_numpy(s["tokens"]),
                              use_pallas=use_pallas).numpy()
    assert got.shape == want.shape == (B, S, s["cfg"].model.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


def test_prefill_and_decode_step_match_reference(setup):
    s = setup
    jm, m = s["jcfg"].model, s["cfg"].model
    toks = s["tokens"]
    jlog, jcache = jax_transformer.prefill(s["jq"], jm, jnp.asarray(toks),
                                           use_pallas=True)
    tlog, tcache = transformer.prefill(s["tq"], m, torch.from_numpy(toks),
                                       use_pallas=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=_tol(np.asarray(jlog)))
    assert tcache.keys() == jcache.keys()
    for key in jcache:
        for n in ("k", "v"):
            want = np.asarray(jcache[key][n], np.float32)
            got = tcache[key][n].float().numpy()
            assert got.shape == want.shape
            # bf16 cache entries: within 2^-5 of the largest entry
            np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))

    # one decode step at t = S against generation-sized caches
    jfull = jax_engine._merge_prefill_caches(
        jax_transformer.init_caches(jm, B, S + 1), jcache, S)
    tfull = engine._merge_prefill_caches(
        transformer.init_caches(m, B, S + 1, device="cpu"), tcache, S)
    tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    jd, _ = jax_transformer.decode_step(s["jq"], jm, jnp.asarray(tok), jfull,
                                        jnp.int32(S), use_pallas=True)
    td, tfull = transformer.decode_step(s["tq"], m, torch.from_numpy(tok),
                                        tfull, S, use_pallas=True)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=_tol(np.asarray(jd)))


def test_engine_greedy_matches_reference_engine(setup):
    s = setup
    jeng = jax_engine.Engine(s["jcfg"], s["jp"], s["js"])
    teng = engine.Engine(s["cfg"], s["tp"], s["ts"], device="cpu")
    jout, jlog = jeng.generate(jnp.asarray(s["tokens"]), NEW)
    tout, tlog = teng.generate(torch.from_numpy(s["tokens"]), NEW)
    jout, tout = np.asarray(jout), tout.numpy()
    assert tout.shape == (B, NEW) and tout.dtype == np.int32
    # The reference's logits before each generated token (teacher-forced on
    # its own output) give the top-1/top-2 margin of every choice.
    seq = np.concatenate([s["tokens"], jout], axis=1)
    logits = np.asarray(jax_transformer.forward(
        s["jq"], s["jcfg"].model, tokens=jnp.asarray(seq), use_pallas=True))
    tol = _tol(logits)
    for b in range(B):
        for i in range(NEW):
            top2 = np.sort(logits[b, S - 1 + i])[-2:]
            if top2[1] - top2[0] <= 2 * tol:
                break               # a near tie: later tokens may differ
            assert tout[b, i] == jout[b, i], (b, i)
    if np.array_equal(tout, jout):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=_tol(np.asarray(jlog)))


def test_temperature_sampling_is_seeded(setup):
    s = setup
    teng = engine.Engine(s["cfg"], s["tp"], s["ts"], device="cpu")
    toks = torch.from_numpy(s["tokens"])
    a, _ = teng.generate(toks, 3, temperature=1.0, seed=7)
    b, _ = teng.generate(toks, 3, temperature=1.0, seed=7)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < s["cfg"].model.vocab_size
