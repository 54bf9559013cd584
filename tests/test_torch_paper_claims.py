"""The port's analytic models (``repro_torch.core``: ``params``, ``dram``,
``topology``, ``vlsi``, ``latency``, ``emulation``) against the
reference's, and the paper's headline claims on the port's numbers.

Every sweep is computed once per package in a module fixture and the two
are held equal exactly (Python float equality, not a tolerance; the
reference's mean access latency is memoised for the fixture, as the
port's is, which changes no value):
the DDR3 baseline, every chip and interposer floorplan of Figs. 5-7, the
Fig. 9 latency sweeps, the Fig. 10-13 slowdown sweeps, the tiers' prices,
``admission_score`` over a grid, the swap break-even, the hot-set fit and
the binary-size overhead.  ``benchmarks/figs_torch.py``'s rows carry the
names and ``derived`` strings of the reference's nine figure modules, row
for row (the rows reuse the fixture's sweeps; ``us_per_call`` is a wall
time and is not compared).  The claims are those of
``tests/test_paper_claims.py``: the DDR3 35 ns baseline, the folded Clos
at 2-5x DDR3 for large emulations, Dhrystone and compiler slowdowns of
2-3x up to 4096 tiles.
"""
import dataclasses
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

SYSTEMS = (1024, 4096)
FIGURES = ("fig5_chip_area", "fig6_components", "fig7_interposer",
           "fig9_latency", "fig10_slowdown", "fig11_mix_sweep",
           "fig12_cache", "fig13_tiers", "tab_binary_size")
#: the sweep functions the figures call, memoised while the fixture runs
SWEEPS = (("latency", "fig9_sweep"), ("emulation", "fig10_sweep"),
          ("emulation", "fig11_sweep"), ("emulation", "fig_cache_sweep"),
          ("emulation", "fig_swap_sweep"), ("emulation", "fig_tier_sweep"))


def _memo(fn):
    cache = {}

    def call(*args, **kw):
        key = (args, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = fn(*args, **kw)
        return cache[key]
    return call


def _memo_mean(method):
    """``LatencyModel.mean_access_latency`` kept by (system, tiles,
    client): a pure function, which the sweeps ask for with the same
    arguments hundreds of times (the port keeps the same cache)."""
    cache = {}

    def call(self, n_emulation_tiles, client=None):
        key = (self.sys, n_emulation_tiles, client)
        if key not in cache:
            cache[key] = method(self, n_emulation_tiles, client)
        return cache[key]
    return call


def _hot_set_traces(em) -> list:
    rng = np.random.default_rng(0)
    out = []
    for cap in (8.0, 16.0, 64.0, 256.0):
        h = em.CacheConfig(cap, 48.0).hit_rate()
        total = int(rng.integers(5_000, 50_000))
        out.append({"capacity_kb": cap, "hits": round(h * total),
                    "misses": total - round(h * total)})
    return out


def _compute(pkg: str) -> dict:
    """Every sweep and price of one package's models."""
    dram, latency, emulation, vlsi = (
        importlib.import_module(f"{pkg}.core.{m}")
        for m in ("dram", "latency", "emulation", "vlsi"))
    em = emulation
    out = {"ddr3": [dram.paper_baseline(c) for c in (1, 2, 4, 8, 16)],
           "ddr3_cycles": dram.DRAMSystem().random_access_latency_cycles()}
    out["chips"] = [dataclasses.asdict(vlsi.chip(net, n, kb))
                    for net in ("clos", "mesh")
                    for kb in (64, 128, 256, 512)
                    for n in (16, 32, 64, 128, 256, 512)]
    out["interposers"] = [dataclasses.asdict(vlsi.interposer(net, c, t, 128))
                          for net in ("clos", "mesh") for t in (128, 256, 512)
                          for c in (2, 4, 8, 16)]
    for s in SYSTEMS:
        out[f"fig9/{s}"] = latency.fig9_sweep(s)
        out[f"fig10/{s}"] = em.fig10_sweep(s)
        out[f"fig11/{s}"] = em.fig11_sweep(s)
        out[f"cache/{s}"] = em.fig_cache_sweep(s)
        out[f"tier/{s}"] = em.fig_tier_sweep(s)
    out["swap/1024"] = em.fig_swap_sweep(1024)
    host, spill = em.HostTierConfig(), em.SpillTierConfig()
    out["tiers"] = [host.roundtrip_cycles(), host.page_in_cycles(),
                    spill.page_in_cycles(), spill.page_out_cycles(),
                    spill.roundtrip_cycles(),
                    em.HostTierConfig(pcie_gbps=4.0,
                                      page_kb=16.0).roundtrip_cycles()]
    out["admission"] = [
        em.admission_score(shared, swap, slots, spill_in_pages=sp)
        for shared in (0, 7, 64) for swap in (0, 1, 5) for slots in (4, 16)
        for sp in (0, swap)]
    out["break_even"] = [em.swap_break_even_accesses(host, c)
                         for c in (1e5, 1e8)]
    out["hot_set"] = [em.fit_hot_set_kb(_hot_set_traces(em)),
                      em.fit_hot_set_kb([{"capacity_kb": 64.0,
                                          "hit_rate": 0.5}]),
                      em.fit_hot_set_kb([])]
    out["binary"] = [em.LOAD_EXTRA_INSTRS, em.STORE_EXTRA_INSTRS,
                     em.COMPILER_BINARY.size_overhead()]
    return out


def _rows(pkg: str) -> list:
    """(name, derived) of every figure row: the port's one module, or the
    reference's nine."""
    if pkg == "repro_torch":
        from benchmarks import figs_torch
        return [(r["name"], r["derived"]) for r in figs_torch.rows()]
    out = []
    for name in FIGURES:
        mod = importlib.import_module(f"benchmarks.{name}")
        out.extend((r["name"], r["derived"]) for r in mod.rows())
    return out


@pytest.fixture(scope="module")
def models():
    """{package: (sweeps, figure rows)}, with the sweep functions memoised
    and the figures' timing loops off while they are computed."""
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        from benchmarks import figs_torch
        mp.setattr(figs_torch, "timeit", lambda *a, **k: 0.0)
        for name in FIGURES:
            mod = importlib.import_module(f"benchmarks.{name}")
            if hasattr(mod, "timeit"):
                mp.setattr(mod, "timeit", lambda *a, **k: 0.0)
        from repro.core import latency
        mp.setattr(latency.LatencyModel, "mean_access_latency",
                   _memo_mean(latency.LatencyModel.mean_access_latency))
        for pkg in ("repro", "repro_torch"):
            for mod, fn in SWEEPS:
                m = importlib.import_module(f"{pkg}.core.{mod}")
                mp.setattr(m, fn, _memo(getattr(m, fn)))
            got[pkg] = (_compute(pkg), _rows(pkg))
    return got


def _equal(models, keys):
    ref, port = models["repro"][0], models["repro_torch"][0]
    for k in keys:
        assert port[k] == ref[k], k


def test_dram_and_vlsi_equal_reference(models):
    """The DDR3 baseline and every Fig. 5-7 floorplan, field for field."""
    _equal(models, ("ddr3", "ddr3_cycles", "chips", "interposers"))


def test_latency_sweeps_equal_reference(models):
    """Fig. 9 at 1024 and 4096 tiles, both networks."""
    _equal(models, [f"fig9/{s}" for s in SYSTEMS])


def test_emulation_sweeps_equal_reference(models):
    """Figs. 10-13 and the swap sweep, the tiers' prices, the scheduler's
    admission scores, the break-even, the hot-set fit, §7.3's binary size;
    the port's scheduler prices admissions with the whole module."""
    from repro_torch.core import emulation
    from repro_torch.serve import scheduler
    keys = [f"{f}/{s}" for f in ("fig10", "fig11", "cache", "tier")
            for s in SYSTEMS]
    _equal(models, keys + ["swap/1024", "tiers", "admission", "break_even",
                           "hot_set", "binary"])
    assert scheduler.admission_score is emulation.admission_score
    assert scheduler.HostTierConfig is emulation.HostTierConfig


def test_figure_rows_equal_reference_modules(models, capsys):
    """``benchmarks/figs_torch.py``'s rows: the nine reference modules'
    names and ``derived`` strings, row for row; its CLI prints the CSV."""
    ref, port = models["repro"][1], models["repro_torch"][1]
    assert len(port) == len(ref) == 176
    for got, want in zip(port, ref):
        assert got == want
    from benchmarks import figs_torch
    figs_torch.main(["tab_binary"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[3] == "tab_binary/compiler-self-compile,0.0,+8.0% (paper +8%)"


def test_ddr3_baseline_35ns(models):
    single, _, multi, _, sixteen = models["repro_torch"][0]["ddr3"]
    assert single == pytest.approx(35.0, abs=2.0)
    assert multi == pytest.approx(36.0, abs=2.0)
    assert sixteen > single


@pytest.mark.parametrize("system_tiles", SYSTEMS)
def test_clos_latency_within_2_to_5x_of_ddr3(models, system_tiles):
    """Folded Clos at 2-5x DDR3 for emulations of 512 tiles and more."""
    out = models["repro_torch"][0]
    base = out["ddr3"][0]
    sweep = out[f"fig9/{system_tiles}"]
    for n, ns in zip(sweep["sizes"], sweep["clos"]):
        if n >= 512:
            assert 2.0 <= ns / base <= 5.0, (n, ns / base)


@pytest.mark.parametrize("system_tiles", SYSTEMS)
def test_slowdown_2_to_3x_up_to_4096_tiles(models, system_tiles):
    """Dhrystone and the compiler at 1.8-3.0x over the whole machine on the
    folded Clos (the sweep's last size is the machine), a speed-up up to
    16 tiles."""
    sweep = models["repro_torch"][0][f"fig10/{system_tiles}"]
    assert sweep["sizes"][-1] == system_tiles
    for mix in ("dhrystone", "compiler"):
        assert 1.8 <= sweep[f"clos/{mix}"][-1] <= 3.0, mix
        assert sweep[f"clos/{mix}"][0] < 1.0
        assert sweep[f"mesh/{mix}"][0] < 1.0
