"""The port stands alone: no JAX and nothing of ``repro`` in ``repro_torch``
or ``chip_smoke.py``, and its entry points refuse to run quietly on the CPU.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import load_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import controller, pushdown, pushup  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import edf_ladder, int8_matmul, kl_hist  # noqa: E402
from repro_torch.kernels import sr_quantize  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine, scheduler  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax\w*|repro)(?:[.\s,]|$)",
                        re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.serve.engine, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.train.train_loop, repro_torch.core.pushdown, "
            "repro_torch.core.pushup, repro_torch.core.sparsity, "
            "repro_torch.kernels.sr_quantize, repro_torch.kernels.edf_ladder, "
            "repro_torch.kernels.fxp_matmul, repro_torch.kernels.ops, "
            "repro_torch.kernels.int8_matmul, repro_torch.kernels.kl_hist, "
            "repro_torch.core.threefry, repro_torch.train.checkpoint, "
            "repro_torch.train.metrics, repro_torch.train.fault_tolerance, "
            "repro_torch.serve.scheduler, repro_torch.serve.journal, "
            "repro_torch.serve.faults, repro_torch.serve.policy, "
            "repro_torch.models.ssm, repro_torch.configs.mamba2_780m, "
            "repro_torch.configs.zamba2_7b, "
            "repro_torch.configs.llama3_2_vision_11b, "
            "repro_torch.configs.hubert_xlarge, repro_torch.data.synthetic, "
            "repro_torch.sharding, repro_torch.distributed, "
            "repro_torch.launch.mesh, repro_torch.quant.qsgd\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'jax', 'jaxlib', 'msgpack') or m.startswith('jax'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f}: imports {hits}"


def test_scan_pattern_catches_what_it_must():
    bad = "import jax\nfrom jax import numpy\nimport repro.config\nfrom repro import x\n"
    ok = "import repro_torch\nfrom repro_torch.x import y\nimport jaxless_thing_is_bad\n"
    assert len(_FORBIDDEN.findall(bad)) == 4
    assert _FORBIDDEN.findall(ok) == ["jaxless_thing_is_bad"]


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config("tiny", overrides=["quant.container_dtype=int8_packed"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(0, cfg.model)
    params = transformer.init_params(0, cfg.model, device="cpu")
    state = controller.init_adapt_state(params, cfg.quant)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.Engine(cfg, params, state)
    eng = engine.Engine(cfg, params, state, device="cpu")
    out, logits = eng.generate(torch.zeros(1, 3, dtype=torch.int32), 2)
    assert out.shape == (1, 2) and torch.isfinite(logits).all()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scheduler.ContinuousBatcher(cfg, params, state, slots=1,
                                    max_context=8)
    cb = scheduler.ContinuousBatcher(cfg, params, state, slots=1,
                                     max_context=8, device="cpu")
    req = cb.submit([1, 2], max_new_tokens=2)
    cb.run_until_drained()
    assert len(req.output) == 2 and cb.decode_captures == 0


def test_unported_archs_and_slots_raise():
    # every arch of the reference's registry is ported: the VLM and the
    # audio encoder load, a cross slot and an encoder initialize
    for arch in ("llama-3.2-vision-11b", "hubert-xlarge"):
        assert get_config(arch).model.name == arch
    with pytest.raises(KeyError, match="unknown"):
        get_config("nope")
    tiny = load_config("tiny").model
    p = transformer.init_params(0, dataclasses.replace(
        tiny, num_layers=2, cross_attn_every=2), device="cpu")
    assert set(p["blocks"]) == {"s0_attn", "s0_mlp", "s1_cross", "s1_mlp"}
    p = transformer.init_params(0, dataclasses.replace(tiny, is_encoder=True),
                                device="cpu")
    assert "embed" not in p and "in_proj" in p
    # mamba and shared-attention slots are ported
    p = transformer.init_params(0, dataclasses.replace(
        tiny, layer_pattern=("mamba",), ssm_state=8, ssm_head_dim=16),
        device="cpu")
    assert p["blocks"]["s0_mamba"]["conv_w"].shape[:2] == (tiny.num_layers, 4)
    p = transformer.init_params(0, dataclasses.replace(
        tiny, shared_attn_weights=True), device="cpu")
    assert p["blocks"] == {} and set(p["shared"]) == {"attn", "mlp"}
    # MoE slots are ported: tiny with experts has an s0_moe block
    moe = load_config("tiny", overrides=["model.num_experts=4",
                                         "model.experts_per_token=2"])
    params = transformer.init_params(0, moe.model, device="cpu")
    assert params["blocks"]["s0_moe"]["we_gate"].ndim == 4
    # the float32 container under the registry's defaults (SR from
    # jax.random noise, no use_pallas) is ported: it quantizes with the
    # step key, and asks for it when only the fused kernels' seeds come
    cfg = load_config("tiny")
    params = transformer.init_params(0, cfg.model, device="cpu")
    state = controller.init_adapt_state(params, cfg.quant)
    with pytest.raises(ValueError, match="step key"):
        controller.quantize_params(params, state, cfg.quant,
                                   controller.leaf_seeds(0, 0, state["tensors"]))
    q = controller.quantize_params(params, state, cfg.quant,
                                   key=controller.step_key(0, 0))
    assert set(q) == set(params)


def test_moe_module_imports_without_jax():
    code = ("import sys\n"
            "import repro_torch.models.moe, repro_torch.configs.gemma2_2b, "
            "repro_torch.configs.mixtral_8x22b, "
            "repro_torch.configs.arctic_480b\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'jax', 'jaxlib') or m.startswith('jax'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_ssm_init_params_raise_without_cuda(monkeypatch, arch):
    from repro_torch.configs import get_smoke_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = get_smoke_config(arch).model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(0, m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_caches(m, 1, 8)
    caches = transformer.init_caches(m, 1, 8, device="cpu")
    assert caches["s0_mamba"]["ssm"].dtype == torch.float32
    assert caches["s0_mamba"]["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_moe_init_params_raise_without_cuda(monkeypatch, arch):
    from repro_torch.configs import get_smoke_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = get_smoke_config(arch).model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(0, m)
    p = transformer.init_params(0, m, device="cpu")
    blk = p["blocks"]["s0_moe"]
    assert blk["we_up"].shape == (m.num_layers, m.num_experts, m.d_model,
                                  m.d_ff)
    assert blk["router"].device.type == "cpu"
    assert ("dense" in blk) == bool(m.dense_residual_d_ff)


def test_training_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config("tiny", overrides=[
        "quant.container_dtype=int8_packed", "quant.stochastic_rounding=false",
        "train.global_batch=2", "train.seq_len=8"])
    for call in (lambda: train_loop.init_state(cfg),
                 lambda: synthetic.lm_batch(cfg, 0),
                 lambda: train_loop.train(cfg, steps=1),
                 lambda: train_launcher.main(["--arch", "tiny"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    state, _ = train_loop.train(cfg, steps=1, device="cpu", log=lambda s: None)
    assert int(state["step"]) == 1 and state["params"]["embed"].device.type == "cpu"


def test_new_kernel_wrappers_take_the_card_or_raise():
    """A CPU tensor takes the plain version (no launch counted); a tensor
    on any other device than the CPU or CUDA raises rather than fall back."""
    x = torch.zeros(2, 8)
    fl = torch.zeros(2, dtype=torch.int32)
    n0 = sr_quantize.sr_quantize_fused_stacked_int8.launches
    assert sr_quantize.sr_quantize_fused_stacked_int8(x, 3, fl).dtype == \
        torch.int8
    assert sr_quantize.sr_quantize_fused_stacked_int8.launches == n0
    w = torch.randn(1, 64)
    fls = torch.zeros(1, len(pushdown.WL_LADDER), dtype=torch.int32)
    counts = edf_ladder.edf_ladder_hists(
        w, fls, torch.tensor([50], dtype=torch.int32),
        wl_ladder=pushdown.WL_LADDER, r_upr=150)
    assert counts.shape == (1, 1 + len(pushdown.WL_LADDER), 150)
    assert edf_ladder.edf_ladder_hists.launches == 0
    meta = torch.zeros(2, 8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        sr_quantize.sr_quantize_fused_stacked_int8(
            meta, 3, torch.zeros(2, dtype=torch.int32, device="meta"))
    assert pushup.ST_MAX == 2


def test_ops_only_kernel_wrappers_take_the_card_or_raise():
    """The three kernels only ``kernels/ops`` reaches: a CPU tensor takes
    the plain version (no launch counted); a tensor on any other device
    than the CPU or CUDA raises rather than fall back; and their sources
    lie beside the others, built at first use."""
    n0 = (sr_quantize.sr_quantize.launches, int8_matmul.int8_matmul.launches,
          kl_hist.kl_hist.launches)
    x = torch.zeros(2, 8)
    assert sr_quantize.sr_quantize(x, x, 8, 4).dtype == torch.float32
    words = torch.ones(2, 8, dtype=torch.int8)
    assert int8_matmul.int8_matmul(words, words.T.contiguous(),
                                   torch.tensor(1.0)).shape == (2, 2)
    assert kl_hist.kl_hist(x, x, 8).shape == (2, 8)
    assert (sr_quantize.sr_quantize.launches,
            int8_matmul.int8_matmul.launches,
            kl_hist.kl_hist.launches) == n0
    meta = torch.zeros(8, device="meta")
    for call in (lambda: sr_quantize.sr_quantize(meta, meta, 8, 4),
                 lambda: kl_hist.kl_hist(meta, meta, 8),
                 lambda: int8_matmul.int8_matmul(
                     words.to("meta"), words.T.contiguous().to("meta"),
                     torch.tensor(1.0))):
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            call()
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    for name in ("int8_matmul", "kl_hist", "sr_quantize"):
        assert (csrc / f"{name}.cu").exists()
    assert "sr_quantize_launch" in (csrc / "sr_quantize.cu").read_text()
