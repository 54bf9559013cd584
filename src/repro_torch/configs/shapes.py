"""Assigned input shapes and their per-architecture applicability (a port
of ``repro.configs.shapes``).

Four shapes per architecture (40 cells total):

  train_4k    : seq 4,096  x global_batch 256   -> train_step
  prefill_32k : seq 32,768 x global_batch 32    -> prefill (inference)
  decode_32k  : seq 32,768 x global_batch 128   -> serve_step (1 new token,
                KV cache of 32k)
  long_500k   : seq 524,288 x global_batch 1    -> serve_step; requires
                sub-quadratic attention (SSM / hybrid / sliding-window);
                skipped for pure full-attention archs (DESIGN.md §4)

Where the reference hands the dry-run ``ShapeDtypeStruct`` stand-ins,
:func:`input_specs` hands tensors on the ``meta`` device: shape and dtype,
no storage.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether the (arch, shape) cell runs, and why not if it doesn't."""
    if shape_name != "long_500k":
        return True, ""
    if cfg.family in ("ssm", "hybrid"):
        return True, ""
    if cfg.window is not None:
        return True, ""          # SWA: KV bounded by the window
    return False, ("pure full-attention arch: 500k-token decode requires "
                   "sub-quadratic attention (skip recorded in DESIGN.md §4)")


def config_for_shape(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """Shape-dependent implementation choices."""
    shape = SHAPES[shape_name]
    updates: dict = {}
    if shape.kind == "train":
        updates.update(logical_rules="fsdp_tp", remat="block")
    elif shape.kind == "prefill":
        updates.update(logical_rules="tp_only", remat="none")
    else:  # decode
        updates.update(logical_rules="tp_only", remat="none")
        # the emulated-memory paged layout when a single sequence's KV must
        # be spread over many devices; batch layout when batch >= DP axis
        if shape_name == "long_500k" and cfg.family != "ssm":
            updates.update(kv_layout="paged", kv_page_slots=1024)
        else:
            updates.update(kv_layout="batch")
    return dataclasses.replace(cfg, **updates)


def input_specs(cfg: ModelConfig, shape_name: str,
                reduced: tuple[int, int] | None = None) -> dict:
    """Meta-tensor stand-ins for the step's data inputs.

    ``reduced``: optional (batch, seq) override for smoke tests.
    """
    shape = SHAPES[shape_name]
    b, s = (shape.global_batch, shape.seq_len) if reduced is None else reduced
    embeds_in = cfg.frontend is not None
    d = cfg.d_model
    cdt = torch_dtype(cfg.compute_dtype)

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        specs = {"labels": spec((b, s), torch.int32),
                 "mask": spec((b, s), torch.float32)}
        if cfg.family == "encdec":
            specs["embeds"] = spec((b, s, d), cdt)
            specs["tokens"] = spec((b, s), torch.int32)
        elif embeds_in:
            specs["embeds"] = spec((b, s, d), cdt)
        else:
            specs["tokens"] = spec((b, s), torch.int32)
        return specs
    if shape.kind == "prefill":
        if cfg.family == "encdec" or embeds_in:
            return {"embeds": spec((b, s, d), cdt)}
        return {"tokens": spec((b, s), torch.int32)}
    # decode: one new token against a seq_len cache
    return {"tokens": spec((b, 1), torch.int32),
            "lengths": spec((b,), torch.int32)}
