"""Seeded trace-driven load generation for the serving stack.

The hand-built serving workloads are token-identity scenarios: every
request is submitted up front and the queue drains.  Production traffic is
none of that -- arrivals are a Poisson process, prompt popularity is
Zipf-distributed over a population of system prompts / few-shot templates,
and prompt/output lengths are bursty and bimodal (chat turns vs document
jobs).  This module generates such traffic from a tiny seeded config and
replays it against the engine's real step loop, so requests genuinely
queue, contend for KV frames, get preempted and resume -- the load under
which the telemetry layer's p99 TTFT / ITL numbers mean something.

Everything is denominated in decode steps (the :class:`StepClock` the
engine's telemetry carries): an arrival at step 40 is submitted once 40
decode steps (or explicit idle ticks) have elapsed.  Generation is pure
``numpy.random.default_rng(seed)`` arithmetic -- the same ``TraceConfig``
produces a byte-identical schedule on every platform, mesh size and rerun,
so benchmark headline numbers are exactly reproducible.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.serve.engine import Request
from repro_torch.serve.scheduler import Scheduler


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """A complete description of one synthetic traffic trace.

    Arrivals: a Poisson process -- exponential inter-arrival gaps with mean
    ``1 / arrival_rate`` decode steps, cumulatively summed and floored to
    integer arrival steps.

    Prompt popularity: a population of ``n_prompts`` distinct prompts with
    Zipf(``zipf_alpha``) popularity over popularity rank -- rank-1 is the
    shared system prompt almost everyone hits, the tail is effectively
    cold.  Each request appends ``tail_len`` fresh random tokens so popular
    prompts exercise prefix sharing + copy-on-write rather than being
    byte-identical requests.

    Lengths: bimodal.  A prompt is long with probability
    ``prompt_long_frac`` (population-level: a prompt's length is a property
    of the prompt, not the request), and a request's output budget is long
    with probability ``out_long_frac``.
    """
    seed: int = 0
    n_requests: int = 32
    #: mean arrivals per decode step (Poisson process intensity)
    arrival_rate: float = 0.25
    #: distinct prompts in the popularity population
    n_prompts: int = 8
    #: Zipf popularity skew over prompt rank (larger = hotter head)
    zipf_alpha: float = 1.2
    prompt_len_short: int = 4
    prompt_len_long: int = 16
    prompt_long_frac: float = 0.25
    #: per-request random suffix appended to the population prompt
    tail_len: int = 2
    out_len_short: int = 2
    out_len_long: int = 8
    out_long_frac: float = 0.25
    vocab_size: int = 64


@dataclasses.dataclass(frozen=True)
class TraceItem:
    """One request of a generated trace."""
    uid: int
    arrival_step: int
    prompt: np.ndarray            # [S] int32 (population prompt + tail)
    max_new_tokens: int
    prompt_id: int                # popularity rank of the population prompt


def zipf_weights(n: int, alpha: float) -> np.ndarray:
    """Normalized Zipf popularity over ranks 1..n: P(rank k) ~ k^-alpha."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(alpha)
    return w / w.sum()


def generate(cfg: TraceConfig) -> list[TraceItem]:
    """Generate the trace: deterministic in ``cfg`` (seed included).

    The rng draw order is part of the schedule contract -- changing it
    changes every committed benchmark number -- so draws happen in one
    fixed sequence: population lengths, population tokens, per-request
    popularity picks, inter-arrival gaps, output budgets, tails."""
    if cfg.n_requests < 0 or cfg.n_prompts < 1:
        raise ValueError(f"bad trace size: {cfg.n_requests} requests over "
                         f"{cfg.n_prompts} prompts")
    if cfg.arrival_rate <= 0:
        raise ValueError(f"arrival_rate must be > 0, got {cfg.arrival_rate}")
    rng = np.random.default_rng(cfg.seed)
    long_prompt = rng.random(cfg.n_prompts) < cfg.prompt_long_frac
    lens = np.where(long_prompt, cfg.prompt_len_long, cfg.prompt_len_short)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    pids = rng.choice(cfg.n_prompts, size=cfg.n_requests,
                      p=zipf_weights(cfg.n_prompts, cfg.zipf_alpha))
    gaps = rng.exponential(1.0 / cfg.arrival_rate, cfg.n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    long_out = rng.random(cfg.n_requests) < cfg.out_long_frac
    outs = np.where(long_out, cfg.out_len_long, cfg.out_len_short)
    items = []
    for i in range(cfg.n_requests):
        tail = rng.integers(0, cfg.vocab_size, cfg.tail_len).astype(np.int32)
        items.append(TraceItem(
            uid=i, arrival_step=int(arrivals[i]),
            prompt=np.concatenate([prompts[int(pids[i])], tail]),
            max_new_tokens=int(outs[i]), prompt_id=int(pids[i])))
    return items


def replay(items: list[TraceItem], sched: Scheduler,
           max_ticks: int = 100_000) -> list[Request]:
    """Replay a trace against the engine step loop.

    Each tick, every trace item whose arrival step has come (by the
    engine's decode-step clock) is submitted, then the scheduler runs one
    ordinary loop iteration.  When the engine is idle with arrivals still
    pending, the clock is ticked explicitly -- idle time passes at one
    step per tick, exactly what a decode step would have cost, so queue
    waits and TTFTs stay decode-step denominated.  Requests therefore
    genuinely queue: a burst of arrivals contends for slots and frames and
    the tail of the TTFT distribution is the contention, not an artifact
    of submitting everything up front."""
    engine = sched.engine
    clock = engine.metrics.clock
    pending = collections.deque(
        sorted(items, key=lambda t: (t.arrival_step, t.uid)))
    ticks = 0
    while pending or sched.queue \
            or any(r is not None for r in engine.slot_req):
        while pending and pending[0].arrival_step <= clock.now():
            item = pending.popleft()
            sched.submit([Request(uid=item.uid, prompt=item.prompt,
                                  max_new_tokens=item.max_new_tokens)])
        # a fused decode run may not pass the next arrival: the request
        # must be submitted at exactly the step it would have been under
        # stepwise replay (arrival timestamps are part of trace identity)
        cap = (max(1, int(pending[0].arrival_step) - clock.now())
               if pending else None)
        if not sched.tick(max_steps=cap):
            if sched.queue:
                raise RuntimeError(
                    f"request uid={sched.queue[0].uid} can never be "
                    f"admitted (prompt too long for max_len, or needs "
                    f"more KV frames than the pool holds)")
            if pending:
                clock.tick()        # idle: time passes until the arrival
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError("trace replay exceeded max_ticks")
    sched._drain_completed()        # completions from before the first step
    return sched.completed
