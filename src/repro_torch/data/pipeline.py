"""Deterministic synthetic data pipeline (a numpy copy of
``repro.data.pipeline``).

Batches are a pure function of (seed, step), so a restarted job resumes with
bit-identical data order -- the substrate the fault-tolerance layer's
deterministic-restart guarantee rests on.  Token streams follow a Zipfian
unigram distribution with a shift-register dependency so the LM loss has
learnable structure.  Every array is drawn exactly as the reference draws
it, so the batches are bit-equal to the reference's; the frame embeddings
of the enc-dec and frontend archs are cast to the compute dtype through
torch (a CPU tensor), since numpy has no bfloat16.

Host sharding: ``local_batch(step, host_id, n_hosts)`` carves the global
batch by host; device placement is the trainer's job.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Deterministic synthetic LM stream for a model config."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        rng = np.random.default_rng(data.seed)
        v = cfg.vocab_size
        # Zipf over a shuffled alphabet; dependency: x[t] ~ f(x[t-1]) mixes in
        # a per-token deterministic successor half the time.
        ranks = rng.permutation(v)
        p = 1.0 / np.arange(1, v + 1) ** data.zipf_a
        self._probs = (p / p.sum())[np.argsort(ranks)]
        self._succ = rng.permutation(v)

    def global_batch(self, step: int) -> dict:
        """Batch for ``step``: numpy ``labels`` [B, S] int32, ``mask``
        [B, S] f32 and ``tokens`` [B, S] int32 (decoders and enc-dec); for
        enc-dec and frontend archs ``embeds`` [B, S, d_model], a CPU tensor
        in the compute dtype."""
        d, cfg = self.data, self.cfg
        rng = np.random.default_rng((d.seed, step))
        b, s = d.global_batch, d.seq_len
        draw = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self._probs)
        use_succ = rng.random((b, s + 1)) < 0.5
        toks = draw.copy()
        for t in range(1, s + 1):
            toks[:, t] = np.where(use_succ[:, t],
                                  self._succ[toks[:, t - 1]], draw[:, t])
        batch = {
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((b, s), np.float32),
        }
        if cfg.family == "encdec" or cfg.frontend is not None:
            emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
            batch["embeds"] = torch.from_numpy(emb).to(
                torch_dtype(cfg.compute_dtype))
            if cfg.family == "encdec":
                batch["tokens"] = toks[:, :-1].astype(np.int32)
        else:
            batch["tokens"] = toks[:, :-1].astype(np.int32)
        return batch

    def local_batch(self, step: int, host_id: int, n_hosts: int) -> dict:
        g = self.global_batch(step)
        b = self.data.global_batch
        assert b % n_hosts == 0
        lo = (b // n_hosts) * host_id
        hi = lo + b // n_hosts
        return {k: v[lo:hi] for k, v in g.items()}

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, step: int):
        """The batches of ``step``, ``step + 1``, ...: a resumed run's data
        order."""
        while True:
            yield self.global_batch(step)
            step += 1
