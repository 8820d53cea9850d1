"""The port stands alone: no JAX and nothing of ``repro`` in ``repro_torch``
or ``chip_smoke.py``, and its entry points refuse to run quietly on the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import load_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax\w*|repro)(?:[.\s,]|$)",
                        re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.serve.engine, "
            "repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'jax', 'jaxlib') or m.startswith('jax'))\n"
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


def test_unported_archs_and_slots_raise():
    with pytest.raises(KeyError, match="slice"):
        get_config("gemma2-2b")
    with pytest.raises(KeyError, match="unknown"):
        get_config("nope")
    moe = load_config("tiny", overrides=["model.num_experts=4"])
    with pytest.raises(NotImplementedError, match="MoE"):
        transformer.init_params(0, moe.model, device="cpu")
    cfg = load_config("tiny")      # float32 container: the training slice
    params = transformer.init_params(0, cfg.model, device="cpu")
    with pytest.raises(NotImplementedError, match="training slice"):
        engine.Engine(cfg, params, controller.init_adapt_state(params, cfg.quant),
                      device="cpu")
