"""The paper's figures and §7.3 table through the port's analytic models.

One module for the reference's nine (``fig5_chip_area``,
``fig6_components``, ``fig7_interposer``, ``fig9_latency``,
``fig10_slowdown``, ``fig11_mix_sweep``, ``fig12_cache``, ``fig13_tiers``,
``tab_binary_size``): the same rows, names and ``derived`` strings, each
computed through ``repro_torch.core`` (host arithmetic; no JAX, no card).
``us_per_call`` is the host's median wall time of the row's sweep.

Run: PYTHONPATH=src:. python -m benchmarks.figs_torch [filter]
"""
from __future__ import annotations

import sys

from benchmarks.common import print_csv, row, timeit
from repro_torch.core import dram, emulation, latency, vlsi


def fig5_chip_area() -> list[dict]:
    """Fig. 5: total chip area vs tile count, folded Clos and 2D mesh."""
    out = []
    for net in ("clos", "mesh"):
        for mem_kb in (64, 128, 256, 512):
            for n in (16, 32, 64, 128, 256, 512):
                us = timeit(vlsi.chip, net, n, mem_kb)
                c = vlsi.chip(net, n, mem_kb)
                out.append(row(
                    f"fig5/{net}/{n}t/{mem_kb}KB", us,
                    f"total={c.total_mm2:.1f}mm2 io={c.io_mm2:.1f} "
                    f"econ={c.economical}"))
    c = vlsi.clos_chip(256, 128)
    m = vlsi.mesh_chip(256, 128)
    out.append(row("fig5/anchor/clos-256-128", 0.0,
                   f"total={c.total_mm2:.1f} (paper 132.9) "
                   f"io={c.io_mm2:.1f} (paper 44.6)"))
    out.append(row("fig5/anchor/mesh-256-128", 0.0,
                   f"total={m.total_mm2:.1f} (paper 87.9) "
                   f"ratio={c.total_mm2 / m.total_mm2:.2f} (paper 1.13-1.43)"))
    return out


def fig6_components() -> list[dict]:
    """Fig. 6: switch/wire/IO area as % of die, vs tile count (256 KB)."""
    out = []
    for net in ("clos", "mesh"):
        for n in (16, 32, 64, 128, 256, 512):
            us = timeit(vlsi.chip, net, n, 256)
            c = vlsi.chip(net, n, 256)
            sw = (c.edge_switch_mm2 + c.switch_group_mm2) / c.total_mm2
            wire = c.channel_wire_mm2 / c.total_mm2
            out.append(row(
                f"fig6/{net}/{n}t", us,
                f"switch={100 * sw:.2f}% wire={100 * wire:.2f}% "
                f"io={100 * c.io_frac:.1f}% "
                f"ic={100 * c.interconnect_frac:.1f}%"))
    return out


def fig7_interposer() -> list[dict]:
    """Fig. 7: interposer area for multi-chip systems + channel fraction."""
    out = []
    for net in ("clos", "mesh"):
        for tiles_per_chip in (128, 256, 512):
            for n_chips in (2, 4, 8, 16):
                us = timeit(vlsi.interposer, net, n_chips, tiles_per_chip,
                            128)
                ip = vlsi.interposer(net, n_chips, tiles_per_chip, 128)
                out.append(row(
                    f"fig7/{net}/{n_chips}x{tiles_per_chip}t", us,
                    f"total={ip.total_mm2:.0f}mm2 "
                    f"chan={100 * ip.channel_frac:.1f}% "
                    f"wire={ip.min_wire_ns:.2f}-{ip.max_wire_ns:.2f}ns"))
    return out


def fig9_latency() -> list[dict]:
    """Fig. 9: emulated-memory access latency vs emulation size."""
    out = []
    base = dram.paper_baseline(1)
    out.append(row("fig9/ddr3-baseline", 0.0,
                   f"{base:.1f}ns (paper 35); multi-rank "
                   f"{dram.paper_baseline(4):.1f}ns (paper 36)"))
    for system in (1024, 4096):
        us = timeit(latency.fig9_sweep, system)
        sweep = latency.fig9_sweep(system)
        for i, n in enumerate(sweep["sizes"]):
            c, m = sweep["clos"][i], sweep["mesh"][i]
            out.append(row(
                f"fig9/{system}sys/{n}t", us if i == 0 else 0.0,
                f"clos={c:.1f}ns ({c / base:.2f}x ddr3) mesh={m:.1f}ns "
                f"(mesh/clos={m / c:.2f})"))
    return out


def fig10_slowdown() -> list[dict]:
    """Fig. 10: Dhrystone/compiler slowdown vs emulation size."""
    out = []
    for system in (1024, 4096):
        us = timeit(emulation.fig10_sweep, system)
        sweep = emulation.fig10_sweep(system)
        for i, n in enumerate(sweep["sizes"]):
            out.append(row(
                f"fig10/{system}sys/{n}t", us if i == 0 else 0.0,
                f"clos/dhry={sweep['clos/dhrystone'][i]:.2f} "
                f"clos/comp={sweep['clos/compiler'][i]:.2f} "
                f"mesh/dhry={sweep['mesh/dhrystone'][i]:.2f} "
                f"mesh/comp={sweep['mesh/compiler'][i]:.2f}"))
    return out


def fig11_mix_sweep() -> list[dict]:
    """Fig. 11: slowdown vs global-access fraction (local fixed at 20%)."""
    out = []
    for system in (1024, 4096):
        us = timeit(emulation.fig11_sweep, system)
        sweep = emulation.fig11_sweep(system)
        for i, g in enumerate(sweep["global_frac"]):
            out.append(row(
                f"fig11/{system}sys/g{int(100 * g):02d}",
                us if i == 0 else 0.0,
                f"clos={sweep['clos'][i]:.2f} mesh={sweep['mesh'][i]:.2f}"))
    return out


def fig12_cache() -> list[dict]:
    """Slowdown vs hot-page cache size under the Dhrystone mix."""
    out = []
    for system in (1024, 4096):
        us = timeit(emulation.fig_cache_sweep, system)
        sweep = emulation.fig_cache_sweep(system)
        for i, c in enumerate(sweep["cache_kb"]):
            out.append(row(
                f"fig12/{system}sys/{c}kb", us if i == 0 else 0.0,
                f"hit={sweep['hit_rate'][i]:.3f} "
                f"clos={sweep['clos'][i]:.2f} mesh={sweep['mesh'][i]:.2f}"))
    return out


def fig13_tiers() -> list[dict]:
    """Slowdown vs the fraction of host faults served from the spill tier
    (at 1% of misses faulting to host), under the Dhrystone mix."""
    out = []
    for system in (1024, 4096):
        us = timeit(emulation.fig_tier_sweep, system)
        sweep = emulation.fig_tier_sweep(system)
        for i, f in enumerate(sweep["spill_frac"]):
            out.append(row(
                f"fig13/{system}sys/spill{f:.2f}", us if i == 0 else 0.0,
                f"clos={sweep['clos'][i]:.2f} mesh={sweep['mesh'][i]:.2f}"))
        out.append(row(
            f"fig13/{system}sys/fault_cycles", 0.0,
            f"host={sweep['host_fault_cycles']:.0f} "
            f"spill={sweep['spill_fault_cycles']:.0f}"))
    return out


def tab_binary_size() -> list[dict]:
    """§7.3: program-binary size increase from the rewriting."""
    b = emulation.COMPILER_BINARY
    return [
        row("tab_binary/load-overhead", 0.0,
            f"+{emulation.LOAD_EXTRA_INSTRS} instrs (paper +2)"),
        row("tab_binary/store-overhead", 0.0,
            f"+{emulation.STORE_EXTRA_INSTRS} instrs (paper +3)"),
        row("tab_binary/compiler-self-compile", 0.0,
            f"+{100 * b.size_overhead():.1f}% (paper +8%)"),
    ]


#: the figures in the reference runner's order, by its module names
FIGURES = (fig5_chip_area, fig6_components, fig7_interposer, fig9_latency,
           fig10_slowdown, fig11_mix_sweep, fig12_cache, fig13_tiers,
           tab_binary_size)


def rows(only: str | None = None) -> list[dict]:
    """Every figure's rows, or those of the figures whose name holds
    ``only``."""
    out = []
    for fig in FIGURES:
        if only is None or only in fig.__name__:
            out.extend(fig())
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    print_csv(rows(argv[0] if argv else None))


if __name__ == "__main__":
    main()
