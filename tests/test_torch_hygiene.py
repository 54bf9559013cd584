"""Port hygiene: the PyTorch package and chip_smoke.py import neither JAX
nor the reference package, and the entry points refuse to fall back to the
CPU silently when no CUDA device is present."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    assert len(PORT_FILES) > 30
    bad = [(str(path.relative_to(ROOT)), name)
           for path in PORT_FILES for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no GPU, Model, the weight bridge and the serve CLI raise unless
    the caller asks for the CPU; asking for it works."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.weights import from_jax_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1"])
    assert Model(cfg, device="cpu").device.type == "cpu"
