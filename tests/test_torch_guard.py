"""The port stands alone: no JAX, no reference package, GPU by default."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _is_forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "repro" \
        or name.startswith("repro.")


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = _port_modules()
    assert {"repro_torch.core.engine", "repro_torch.kernels.hfl_ops",
            "repro_torch.kernels.seq_ops", "repro_torch.launch.serve",
            "repro_torch.models.transformer"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _is_forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_hfl_simulation_defaults_to_cuda(no_cuda):
    from repro_torch.configs.hfl_mnist import CONFIG
    from repro_torch.core.hfl import HFLSimulation
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HFLSimulation(CONFIG)


def test_engine_entry_points_default_to_cuda(no_cuda):
    from repro_torch import convert
    from repro_torch.configs.hfl_mnist import CONFIG
    from repro_torch.core import engine
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.init_simulation(CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_numpy({}, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_warm_seed_and_trace_capture_default_to_cuda(no_cuda, tmp_path):
    from repro_torch.configs.hfl_mnist import CONFIG
    from repro_torch.core import engine
    from repro_torch.telemetry import spans
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.init_warm(CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with spans.trace_capture(str(tmp_path)):
            pass
    assert engine.init_warm(CONFIG, device="cpu").device.type == "cpu"


def test_substrate_entry_points_default_to_cuda(no_cuda):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models.transformer import Transformer
    cfg = get_config("recurrentgemma-9b").reduced()
    for make in (lambda: Transformer(cfg),
                 lambda: steps.make_prefill_step(cfg),
                 lambda: steps.make_serve_step(cfg),
                 lambda: convert.params_from_numpy({}, cfg),
                 lambda: serve.main(["--arch", "recurrentgemma-9b"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device the smoke exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
