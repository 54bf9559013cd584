"""The port's serving-memory benchmark (benchmarks/vm_bench_torch.py) on the
CPU at the reference's bench-tiny: every deterministic field of each
section equals the reference's committed BENCH_vm.json, read here (the
reference reproduces that file; timings and wall clocks are left out).
Weights are the port's own, from seed 0; greedy decoding leaves no
tolerance to state.  Also the serve example over the port: identical
per-request token lines across the batch, paged and pooled layouts."""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from benchmarks import vm_bench_torch as vt  # noqa: E402
from examples import serve_lm_torch as serve_lm  # noqa: E402

torch.set_num_threads(2)

BASELINE = pathlib.Path(__file__).resolve().parents[1] / "BENCH_vm.json"
#: host timings, which no two runs share
TIMED = ("wall_us_", "match_us_", "match_lookup_ratio", "tokens_per_s_")

#: case -> the section functions it runs (sections merged to keep the
#: file's item count small)
CASES = {
    "prefix_sharing+retention": (vt._prefix_rows, vt._retention_rows),
    "swap+tiered": (vt._swap_rows, vt._tiered_rows),
    "prefix_index": (vt._prefix_index_rows,),
    "scheduling": (vt._sched_rows,),
    "slo": (vt._slo_rows,),
    "paged_decode": (vt._paged_decode_rows,),
}


@pytest.fixture(scope="module")
def baseline():
    return json.loads(BASELINE.read_text())


@pytest.fixture(scope="module")
def bench():
    return vt.Bench("cpu")


def _same_as_baseline(got: dict, want: dict):
    keys = [k for k in want if not k.startswith(TIMED)]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.mark.parametrize("case", list(CASES))
def test_section_matches_reference_record(case, bench, baseline):
    record = {}
    for section in CASES[case]:
        section(record, bench)
    for name, got in record.items():
        _same_as_baseline(got, baseline[name])


def test_dispatch_counts_match_reference_record(bench, baseline):
    """Fused, stepwise and reserved replays without the timed ones: 41
    fused against 416 stepwise dispatches, 0.053 transitions per token."""
    rec = vt._dispatch_counts(bench)
    _same_as_baseline(rec, {k: baseline["dispatch"][k] for k in rec})
    assert (rec["dispatches_fused"], rec["dispatches_stepwise"],
            rec["transitions_per_token_fused"]) == (41, 416, 0.053)


def test_serve_example_tokens_identical_across_layouts(capsys):
    lines = {}
    for layout in ("batch", "paged", "pooled"):
        serve_lm.main(["--layout", layout, "--device", "cpu"])
        out = capsys.readouterr().out
        lines[layout] = [ln for ln in out.splitlines() if "req " in ln]
        assert f"kv_layout={layout}: 6 requests, 72 tokens" in out
    assert len(lines["batch"]) == 3
    assert lines["batch"] == lines["paged"] == lines["pooled"]
