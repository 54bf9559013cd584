"""Time the MoE capacity exchange of a data-parallel train step.

At dp > 1 each MoE block's dispatch (``moe._capacity``) exchanges the dp
ranks' per-expert pair counts (``mesh_ctx.dp_offsets``: one all-reduce of
an [n_dp, E] int32 table) and then reads on the host the most pairs the
rank keeps of one expert, which sizes its buffers.  This script runs
``repro_torch.launch.train`` with both wrapped in timers and prints, per
rank, one JSON line: the calls, the seconds in the exchange, the seconds
in the rest of ``_capacity`` (the host read and the arithmetic around it),
and the run's wall seconds.  Under ``torchrun``, with the train driver's
flags:

  PYTHONPATH=src torchrun --nproc_per_node 2 scripts/time_moe_capacity.py \\
      --arch qwen2-moe-a2.7b --smoke --steps 5 --device cpu
"""
import json
import sys
import time

from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.parallel import mesh_ctx


def main(argv=None) -> dict:
    spent = {"capacity_calls": 0, "capacity_s": 0.0, "exchange_calls": 0,
             "exchange_s": 0.0}
    capacity, exchange = moe._capacity, mesh_ctx.dp_offsets

    def timed_capacity(*a, **kw):
        t = time.perf_counter()
        try:
            return capacity(*a, **kw)
        finally:
            spent["capacity_calls"] += 1
            spent["capacity_s"] += time.perf_counter() - t

    def timed_exchange(*a, **kw):
        t = time.perf_counter()
        try:
            return exchange(*a, **kw)
        finally:
            spent["exchange_calls"] += 1
            spent["exchange_s"] += time.perf_counter() - t

    moe._capacity, mesh_ctx.dp_offsets = timed_capacity, timed_exchange
    t = time.perf_counter()
    try:
        res = train.main(argv)
    finally:
        moe._capacity, mesh_ctx.dp_offsets = capacity, exchange
    wall = time.perf_counter() - t
    out = {"rank": int(__import__("os").environ.get("RANK", 0)),
           "wall_s": wall, **spent,
           "read_s": spent["capacity_s"] - spent["exchange_s"],
           "capacity_share_of_wall": spent["capacity_s"] / wall,
           "result": res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
