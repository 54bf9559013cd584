"""Port hygiene: the PyTorch package, chip_smoke.py, the port's benchmark
and its serve example import neither JAX nor the reference package (nor
the reference's benchmark modules), the entry points refuse to fall back
to the CPU silently when no CUDA device is present, and the kernel
packages export the reference's public names."""
import ast
import importlib
import pathlib
import types

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "benchmarks" / "vm_bench_torch.py",
    ROOT / "examples" / "serve_lm_torch.py"]
#: the reference's benchmark modules, which import JAX
REFERENCE_BENCHMARKS = ("benchmarks.vm_bench", "benchmarks.kernel_bench")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_imports_no_jax_and_no_reference():
    assert len(PORT_FILES) > 30
    bad = [(str(path.relative_to(ROOT)), name)
           for path in PORT_FILES for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")
           or name in REFERENCE_BENCHMARKS]
    assert not bad, bad


def _public(module):
    """A module's public names: each callable as such, each submodule alias
    by its path below the top package."""
    out = {}
    for name in dir(module):
        value = getattr(module, name)
        if name.startswith("_"):
            continue
        if isinstance(value, types.ModuleType):
            out[name] = value.__name__.split(".", 1)[1]
        elif callable(value):
            out[name] = "callable"
    return out


def test_kernel_packages_export_the_reference_names():
    """``repro_torch.kernels.<package>`` has the reference's public functions
    and its ``kernel``/``ops``/``ref``-style submodule aliases, naming the
    same modules, for the paged-decode package and the reference's two
    import shims."""
    for package in ("paged_decode", "decode_attention", "emem_gather"):
        reference = importlib.import_module(f"repro.kernels.{package}")
        port = importlib.import_module(f"repro_torch.kernels.{package}")
        assert _public(port) == _public(reference), package


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no GPU, Model, the weight bridge, the serve CLI, the emulated
    memory and its VM raise unless the caller asks for the CPU; asking for
    it works."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import emem
    from repro_torch.emem_vm import EMemVM, VMConfig
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
    spec = emem.EMemSpec(n_slots=256, width=4, page_slots=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        emem.create(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        EMemVM(VMConfig(spec=spec, n_vpages=8))
    assert emem.create(spec, device="cpu").device.type == "cpu"
    vm = EMemVM(VMConfig(spec=spec, n_vpages=8, cache_sets=2), device="cpu")
    assert vm.data.device.type == vm.cache["data"].device.type == "cpu"
