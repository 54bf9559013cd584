"""Request scheduler: residency-aware admission with continuous batching.

Admission asks the engine for headroom (``engine.can_admit``): with a frame
pool a free slot is not enough -- the pool must also hold the pages the
admission immediately needs, after consulting the retention pool and the
live prefix match (or the swap record, for a preempted request whose pages
are parked on host).  Admission is otherwise *optimistic*: decode-time
growth is not reserved up front, and when the pool runs dry the engine
preempts its youngest sequence.  Preempted requests are requeued at the
FRONT of the queue (they are older than anything still waiting); the
scheduler does not care how they resume -- under the engine's swap
preemption re-admission is a swap-in of the parked pages, under the
recompute fallback the generated tokens are folded into the prompt and
greedily re-run -- both are token-identical.

**Residency-aware admission ordering.**  The paper's §7 cost model prices
an access by where the memory already is; the same economics apply to
admission: a request whose prefix pages are retained on device skips their
prefill outright, and one whose swap record is parked on host resumes for
PCIe page bytes instead of re-prefill FLOPs -- both are far cheaper than a
cold prefill of the same length.  Instead of admitting strictly FIFO (and
blocking the whole queue on an inadmissible head), the scheduler scores
the first ``window`` waiting requests with ``engine.admission_cost`` --
the BlockManager's residency terms (shared-prefix tokens, frames to
allocate, swap-in pages), priced into one prefill-FLOPs-vs-PCIe-bytes
score by :func:`repro_torch.core.emulation.admission_score` -- and admits the
best admissible candidate.  Requests an admission cannot cover right now
are *skipped*, not blocked on, so cheap residents behind an expensive cold
head keep the slots busy.

The policy is deliberately degenerate where there is no residency signal:
the batch layout has no BlockManager (``admission_cost`` is None) and the
reserved/"paged" policy's static tables cost nothing to admit, so every
score is 0.0 and ties resolve in queue order -- byte-for-byte FIFO.

``SchedulerConfig`` knobs:

  * ``window`` -- how many waiting requests are scored per admission
    (bounded-window reordering).  ``window=1`` reproduces the original
    FIFO head-of-line admission exactly: only the head is considered, and
    if it cannot be admitted nothing is.
  * ``aging_steps`` -- starvation bound.  A request passed over for this
    many decode steps outranks every score; while an aged request cannot
    be admitted, nothing younger is admitted past it (strict FIFO
    resurrection), so a cold request admits within ``aging_steps`` of the
    queue position it would have held under FIFO.
  * ``host`` -- the :class:`repro_torch.core.emulation.HostTierConfig` pricing
    swap-in PCIe bytes in the score.
  * ``spill`` -- the :class:`repro_torch.core.emulation.SpillTierConfig` pricing
    the extra SPILL -> HOST hop of pages the host tier demoted under
    pressure (``AdmissionCost.spill_in_pages``), so a two-hop restore is
    ranked honestly against an all-host one.
  * ``prefill_cycles_per_token`` -- the §7-model FLOPs proxy for one
    token's prefill; only its ratio to the PCIe page cost matters.

**Score caching.**  The scheduler re-scores its window every decode step,
but most steps change nothing a score depends on: the BlockManager bumps
a monotone ``epoch`` on every mutation that can move an admission cost
(table changes, refcount traffic, retention-pool churn, swap-record
drops, the sharing toggle), so a waiting request whose token count is
unchanged at an unchanged epoch re-uses last tick's
``(AdmissionCost, score)`` pair instead of re-running the prefix match.
Only the *expensive* half is cached -- ``engine.can_admit`` re-runs
fresh on the cached cost every time, because slot availability changes
without any BlockManager mutation (notably under the reserved policy,
whose begin/release are no-ops on the pool).  Cache hits count into the
engine's ``score_cache_hits`` stat.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterable

from repro_torch.core.emulation import (PREFILL_CYCLES_PER_TOKEN, HostTierConfig,
                                  SpillTierConfig, admission_score)
from repro_torch.serve.engine import Request, ServeEngine


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs of the residency-aware admission policy (module docstring)."""
    window: int = 8
    aging_steps: int = 64
    host: HostTierConfig = HostTierConfig()
    spill: SpillTierConfig = SpillTierConfig()
    prefill_cycles_per_token: float = PREFILL_CYCLES_PER_TOKEN


class Scheduler:
    def __init__(self, engine: ServeEngine,
                 cfg: SchedulerConfig | None = None):
        self.engine = engine
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self.queue: collections.deque[Request] = collections.deque()
        self.completed: list[Request] = []
        self._completed_ids: set[int] = set()    # id(req): uids may collide
        self._age: dict[int, int] = {}   # id(req) -> decode steps waited
        #: id(req) -> (identity key, AdmissionCost, score): last tick's
        #: pricing, valid while the BlockManager epoch and the request's
        #: token count are unchanged (module docstring, score caching)
        self._score_cache: dict[int, tuple] = {}

    def submit(self, reqs: Iterable[Request]) -> None:
        """Enqueue new arrivals.  Each is stamped into the engine's
        per-request telemetry (arrival time in decode steps -- queue wait
        and TTFT are measured from here); preempted requests re-enter via
        ``appendleft`` instead and keep their original arrival."""
        for req in reqs:
            self.engine.metrics.on_arrival(req)
            self.queue.append(req)

    # -- admission policy ---------------------------------------------------
    def _score(self, req: Request) -> float:
        """Score one request (a public query -- tests and diagnostics);
        the admission loop itself goes through :meth:`_pick_next`, which
        shares one admission-cost query between check and score."""
        return self._check_and_score(req)[1]

    def _check_and_score(self, req: Request) -> tuple[bool, float]:
        """(admissible now, residency score) off a single
        ``admission_cost`` query -- the prefix match and retention-pool
        walk behind it run once per candidate per pass, not once per
        consumer -- and off NO query at all when the last tick's answer
        is provably current: the cost is a pure function of the request's
        tokens, its swap record and the BlockManager state, so an
        unchanged ``(epoch, token count, swap-record presence)`` key
        replays the cached ``(cost, score)``.  ``can_admit`` re-runs
        fresh either way (slot availability is not under the epoch)."""
        blocks = self.engine.blocks
        if blocks is None:               # no residency signal: FIFO
            return self.engine.can_admit(req), 0.0
        ident = (blocks.epoch, len(req.output),
                 getattr(req, "_swap", None) is not None)
        hit = self._score_cache.get(id(req))
        if hit is not None and hit[0] == ident:
            self.engine.counters["score_cache_hits"] += 1
            return self.engine.can_admit(req, hit[1]), hit[2]
        cost = self.engine.admission_cost(req)
        score = admission_score(
            cost.shared_tokens, cost.swap_in_pages, self.engine.page_slots,
            host=self.cfg.host,
            prefill_cycles_per_token=self.cfg.prefill_cycles_per_token,
            spill_in_pages=cost.spill_in_pages, spill=self.cfg.spill)
        self._score_cache[id(req)] = (ident, cost, score)
        return self.engine.can_admit(req, cost), score

    def _pick_next(self, tried: set[int]) -> int | None:
        """Queue index of the next request to admit, or None to admit
        nothing this pass.  Considers the first ``window`` untried waiting
        requests; an aged request resurrects strict FIFO (nothing younger
        may pass it), otherwise the best-scoring admissible candidate wins
        with ties broken in queue order."""
        cand: list[tuple[int, Request]] = []
        for i, req in enumerate(self.queue):
            if id(req) in tried:
                continue
            cand.append((i, req))
            if len(cand) >= max(1, self.cfg.window):
                break
        for i, req in cand:
            if self._age.get(id(req), 0) >= self.cfg.aging_steps:
                return i if self.engine.can_admit(req) else None
        best, best_score = None, 0.0
        for i, req in cand:
            ok, score = self._check_and_score(req)
            if not ok:
                continue
            if best is None or score > best_score:
                best, best_score = i, score
        return best

    def _admit_waiting(self) -> set[int]:
        """Admit until no slot, no admissible candidate, or queue empty.

        Free slots are re-queried every iteration: an admission that
        preempts (or preempt-completes) another sequence frees slots
        mid-pass, and those must be fillable now, not a decode step later.
        A request that was preempted during this pass is not retried until
        the next pass (its admission just failed; retrying in a loop with
        unchanged headroom would spin).  Returns the ids of those
        passed-over preemptees: their admissibility was never re-evaluated
        after their eviction, so the caller must not fuse past the next
        step while one could be waiting on a free slot."""
        tried: set[int] = set()
        while self.queue:
            slots = self.engine.free_slots()
            if not slots:
                break
            idx = self._pick_next(tried)
            if idx is None:
                break
            req = self.queue[idx]
            del self.queue[idx]
            self._age.pop(id(req), None)
            self._score_cache.pop(id(req), None)
            self.engine.admit(req, slots[0])
            for p in self.engine.drain_preempted():
                tried.add(id(p))
                self.queue.appendleft(p)
            self._drain_completed()   # an admission may preempt-complete
        return tried

    def _requeue_preempted(self) -> None:
        # the engine preempts youngest-first; appendleft in that order
        # leaves the oldest preempted request at the queue front
        for req in self.engine.drain_preempted():
            self.queue.appendleft(req)

    def _drain_completed(self) -> None:
        """Account every completion the engine saw, whenever it happened --
        the engine-side list is the source of truth, not a slot snapshot
        (a request can complete inside admission-time preemption without
        ever being observable in ``slot_req`` between steps)."""
        for req in self.engine.drain_completed():
            if id(req) not in self._completed_ids:
                self._completed_ids.add(id(req))
                self.completed.append(req)

    def tick(self, max_steps: int | None = None) -> bool:
        """One scheduler loop iteration: admit, decode (one step, or one
        fused run of them), requeue preemptions, account completions, age
        the queue by the decode steps that actually ran.  Returns whether
        any slot was active after admission -- False means the engine made
        no progress this tick (idle, or an inadmissible queue head against
        an empty engine).  ``run`` loops this until drained; the trace
        replayer (:func:`repro_torch.serve.tracegen.replay`) interleaves it with
        timed arrivals, passing ``max_steps`` so a fused run never decodes
        past the next arrival.

        When the admission pass ended with a request it preempted mid-pass
        still waiting against a free slot, the tick is forced stepwise:
        that request's admissibility was never re-checked after its own
        eviction freed frames, and the stepwise schedule would retry it on
        the very next tick -- fusing past that retry would change
        admission timing."""
        tried = self._admit_waiting()
        active = any(r is not None for r in self.engine.slot_req)
        if tried and self.queue and self.engine.free_slots():
            max_steps = 1
        n = self.engine.step(max_steps)
        self._requeue_preempted()
        self._drain_completed()
        age = n if n > 0 else 1
        for req in self.queue:
            self._age[id(req)] = self._age.get(id(req), 0) + age
        return active

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until all submitted requests complete."""
        steps = 0
        while (self.queue or any(r is not None
                                 for r in self.engine.slot_req)):
            if not self.tick() and self.queue:
                raise RuntimeError(
                    f"request uid={self.queue[0].uid} can never be admitted "
                    f"(prompt too long for max_len, or needs more KV frames "
                    f"than the pool holds)")
            steps += 1
            if steps > max_steps:
                raise RuntimeError("scheduler exceeded max_steps")
        self._drain_completed()   # completions from before the first step
        return self.completed
