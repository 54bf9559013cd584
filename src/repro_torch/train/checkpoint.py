"""Checkpointing with async save (a port of ``repro.train.checkpoint``, with
its on-disk layout).

Layout: one directory per step, ``step_%08d/``, holding
  - ``index.json``: the step and, per leaf path, its file, shape and dtype
    name;
  - ``<leaf-path>.npy``: one file per leaf, the path's ``/`` written ``__``.

Saves copy the leaves to the host at once and write them on a background
thread (training continues), into ``step_%08d.tmp`` renamed into place when
complete, so a crash mid-save never leaves a half-written step that
:meth:`CheckpointManager.restore` would pick; ``keep`` bounds the steps
kept.  bfloat16 leaves, which numpy cannot hold, are written as their 16-bit
patterns (a 2-byte void array, as numpy stores the reference's ml_dtypes
bfloat16) under the dtype name ``"bfloat16"``, and reloaded bit for bit
with ``Tensor.view(torch.bfloat16)``: a checkpoint of either package
restores in the other.

On a mesh the leaves are logical, whole tensors too.  A save gathers every
DTensor leaf (``full_tensor``, a collective) on the main thread, every
rank in the same order; rank 0 alone writes, through the background
thread, and every rank waits for its commit in :meth:`CheckpointManager.
wait` (a barrier).  ``restore(..., shardings=)`` places the whole tensors
by a tree of :class:`repro_torch.parallel.sharding.NamedSharding` onto any
mesh: elastic re-scaling is a restore with new shardings.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.tree import SEP, flatten, unflatten


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array to write, dtype name to record)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        raise TypeError(f"cannot restore a {dtype} leaf")
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._ranks_wait = False        # a save of DTensors awaits commit
        os.makedirs(directory, exist_ok=True)

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: dict, blocking: bool = False) -> None:
        """Write ``tree`` as step ``step``.  A tree of DTensors is saved by
        every rank of its mesh together (see the module docstring)."""
        self.wait()
        flat = flatten(tree)
        sharded = any(isinstance(v, DTensor) for v in flat.values())
        writer = not sharded or dist.get_rank() == 0
        host = {}
        for k, v in flat.items():
            if isinstance(v, DTensor):
                v = v.full_tensor()
            if writer:
                host[k] = _host(v)
        if self.async_save and not blocking:
            if writer:
                self._thread = threading.Thread(
                    target=self._write, args=(step, host), daemon=True)
                self._thread.start()
            self._ranks_wait = sharded
            return
        if writer:
            self._write(step, host)
        if sharded:
            dist.barrier()

    def wait(self) -> None:
        """Until the last save has committed (on a mesh: on every rank)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._ranks_wait:
            self._ranks_wait = False
            dist.barrier()

    def _write(self, step: int, host: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {"step": step, "leaves": {}}
        for key, (arr, dtype) in host.items():
            fname = key.replace(SEP, "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            index["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "index.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree: dict, step: int | None = None,
                shardings=None, device=None):
        """(tree of ``like_tree``'s structure, step).  With ``shardings``, a
        tree of the same structure of ``NamedSharding``s, each whole tensor
        is placed on its mesh as a DTensor (every rank reads the files);
        else new tensors on ``device``, or on the device of ``like_tree``'s
        leaf at each path (the CPU for a leaf that is not a tensor)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        placing = flatten(shardings) if shardings is not None else {}
        out = {}
        for key, like in flatten(like_tree).items():
            meta = index["leaves"][key]
            t = _tensor(np.load(os.path.join(d, meta["file"])), meta["dtype"])
            if key in placing:
                out[key] = placing[key].place(t)
                continue
            dev = device if device is not None else (
                like.device if isinstance(like, torch.Tensor) else "cpu")
            out[key] = t.to(dev)
        return unflatten(like_tree, out), step
