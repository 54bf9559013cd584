"""Port hygiene: the PyTorch package, chip_smoke.py, the port's benchmarks
(the serving-memory bench, the paper's figures, the kernel, EMem and
roofline benches and their runner), its examples and the
rank bodies the multi-rank tests spawn import neither JAX nor the
reference package (nor the reference's benchmark modules), the entry
points refuse
to fall back to the CPU silently when no CUDA device is present, the
kernel packages export the reference's public names, and every kernel
wrapper refuses a grad-requiring input before its launch."""
import ast
import importlib
import pathlib
import types

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "benchmarks" / "vm_bench_torch.py",
    ROOT / "benchmarks" / "figs_torch.py",
    ROOT / "benchmarks" / "kernel_bench_torch.py",
    ROOT / "benchmarks" / "emem_bench_torch.py",
    ROOT / "benchmarks" / "roofline_torch.py",
    ROOT / "benchmarks" / "run_torch.py",
    ROOT / "examples" / "serve_lm_torch.py",
    ROOT / "examples" / "train_lm_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "emulated_memory_demo_torch.py",
    ROOT / "tests" / "torch_mesh_ranks.py"]
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


def _example(name):
    """An example script of ``examples/`` as a module (not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no GPU, Model, the weight bridge, the serve and train CLIs, the
    quickstart and emulated-memory examples, the emulated memory and its
    VM, and the kernel and EMem benches raise unless the caller asks for
    the CPU; asking for it works.  The dry-run is a host-only tool by
    design (meta tensors over a fake group), as phase paper's figures
    are: it counts without a GPU."""
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
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
    for name in ("quickstart_torch", "emulated_memory_demo_torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(name).main([])
    assert Model(cfg, device="cpu").device.type == "cpu"
    spec = emem.EMemSpec(n_slots=256, width=4, page_slots=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        emem.create(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        EMemVM(VMConfig(spec=spec, n_vpages=8))
    assert emem.create(spec, device="cpu").device.type == "cpu"
    vm = EMemVM(VMConfig(spec=spec, n_vpages=8, cache_sets=2), device="cpu")
    assert vm.data.device.type == vm.cache["data"].device.type == "cpu"
    import sys
    sys.path.insert(0, str(ROOT))
    from benchmarks import emem_bench_torch, kernel_bench_torch
    for bench in (kernel_bench_torch, emem_bench_torch):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.rows()
    from repro_torch.launch import dryrun
    rec = dryrun.count_on_one_rank(cfg, "decode", 2, 16)
    assert rec["roofline"]["flops"] > 0 and rec["fits_80gb"]


#: the kernel wrapper modules, one per CUDA library
WRAPPERS = ("paged_decode/kernel.py", "paged_decode/flash.py",
            "paged_decode/gather.py", "flash_attention/kernel.py",
            "mamba2_ssd/kernel.py")


def _calls(fn):
    """Names of the functions ``fn`` calls, in source order."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            out.append((node.lineno, node.col_offset,
                        f.attr if isinstance(f, ast.Attribute)
                        else getattr(f, "id", "")))
    return [name for *_, name in sorted(out)]


def test_kernel_wrappers_refuse_grad_before_their_launch():
    """In each wrapper module every function that checks its tensors for
    the card (``check_cuda``, which comes before any launch) first calls
    the shared grad guard ``build.check_no_grad``; the guard raises on a
    grad-requiring input while autograd records and lets it pass under
    ``torch.no_grad()``."""
    from repro_torch.kernels import build
    checked = 0
    for rel in WRAPPERS:
        path = ROOT / "src" / "repro_torch" / "kernels" / rel
        for fn in ast.walk(ast.parse(path.read_text(), str(path))):
            if not isinstance(fn, ast.FunctionDef):
                continue
            calls = _calls(fn)
            if "check_cuda" in calls:
                assert "check_no_grad" in calls[:calls.index("check_cuda")], (
                    rel, fn.name)
                checked += 1
    assert checked == 8
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        build.check_no_grad("k", q=x, lengths=torch.ones(2))
    with torch.no_grad():
        build.check_no_grad("k", q=x)
    build.check_no_grad("k", q=x.detach(), w=None)
