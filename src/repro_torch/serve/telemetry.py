"""Per-request SLO telemetry for the serving stack.

The paper's headline claim is a *latency* claim (emulation costs a 2-3x
slowdown, §7), so the serving stack built on the emulation must report what
a deployment actually buys: time-to-first-token (TTFT) and inter-token
latency (ITL) under load -- not just aggregate swap/share counters.  This
module provides the three pieces:

* :class:`StepClock` -- decode-step-denominated time.  Every decode step
  (prefill token or batched decode step) ticks the clock once -- a fused
  multi-step run ticks ``tick(n)`` for its n steps in one call -- and idle
  waits between trace arrivals tick it explicitly, so every latency number
  is an exact integer count of decode steps: deterministic across reruns,
  platforms, mesh sizes and fused-run lengths, and directly comparable to
  the decode-step cost accounting the swap/spill workloads already use.
  Wall-clock time would measure the host Python overhead of this
  toy-scale model, not the policy.

* :class:`RequestTrace` / :class:`Telemetry` -- per-request lifecycle
  tracing: arrival -> first admission -> first token -> completion, with
  queue wait, preemption count, swap/spill page hops and shared prompt
  tokens per request.  Timestamps are taken when a token's logits are
  *computed* (the step it could have been streamed), so a recompute replay
  re-producing an already-produced token does not move its timestamp --
  the recompute cost shows up where it belongs, in the following tokens'
  gaps.  Aggregation is exact-percentile (:func:`percentile` matches
  ``numpy.percentile``'s default linear interpolation) over completed
  requests: p50/p95/p99 TTFT, ITL and queue wait.

* :class:`RollingMonitor` -- a sliding-window live monitor in the style of
  HomebrewNLP's ``wandblog.py`` early-stopping logger: a median over the
  last ``window`` TTFT samples, a *spike* flag when one sample exceeds
  ``spike_factor`` x the sliding median (one request hit a tail), and a
  *regression* flag when the median of the newest half-window exceeds
  ``regress_factor`` x the median of the oldest half-window (the
  distribution itself drifted, not one outlier).

The engine owns one :class:`Telemetry` (``ServeEngine.metrics``), exposes
the summary via ``ServeEngine.telemetry()``, and folds it into the
``shutdown()`` stats under the ``"telemetry"`` key.
"""
from __future__ import annotations

import collections
import dataclasses
import math


def percentile(xs, q: float) -> float | None:
    """Exact q-th percentile (0 <= q <= 100) with linear interpolation --
    byte-for-byte ``numpy.percentile(xs, q)`` on non-empty input, ``None``
    on empty input (numpy raises; telemetry of zero requests is not an
    error, it is just no signal)."""
    if not xs:
        return None
    s = sorted(float(x) for x in xs)
    if len(s) == 1:
        return s[0]
    rank = (len(s) - 1) * (float(q) / 100.0)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    return s[lo] + (s[hi] - s[lo]) * (rank - lo)


def _dist(xs) -> dict:
    """Summary of a latency sample set: count, mean, exact percentiles."""
    if not xs:
        return {"n": 0}
    return {"n": len(xs),
            "mean": round(sum(float(x) for x in xs) / len(xs), 3),
            "p50": round(percentile(xs, 50), 3),
            "p95": round(percentile(xs, 95), 3),
            "p99": round(percentile(xs, 99), 3),
            "max": round(max(float(x) for x in xs), 3)}


class StepClock:
    """Decode-step-denominated time: ``now()`` is the number of decode
    steps (plus explicit idle ticks) since engine construction."""

    def __init__(self) -> None:
        self._now = 0

    def tick(self, n: int = 1) -> None:
        self._now += n

    def now(self) -> int:
        return self._now


@dataclasses.dataclass
class RequestTrace:
    """One request's lifecycle, every timestamp a StepClock reading."""
    uid: int
    arrival: int
    admit: int | None = None          # first admission (queue wait ends)
    completion: int | None = None
    #: production step of generated token i (the decode that computed its
    #: logits); token_steps[0] is the first-token step for TTFT
    token_steps: list[int] = dataclasses.field(default_factory=list)
    admissions: int = 0
    preemptions: int = 0
    swaps: int = 0                    # preemptions parked on the host tier
    resumes: int = 0                  # re-admissions that were swap-ins
    swap_in_pages: int = 0            # PCIe pages moved by those swap-ins
    spill_in_pages: int = 0           # of which promoted two-hop from spill
    shared_tokens: int = 0            # prompt tokens whose prefill was skipped
    #: deepest prefix-index match across this request's fresh admissions,
    #: in whole KV pages -- how far down the radix tree (or linear scan)
    #: the prompt found resident pages
    prefix_match_depth_pages: int = 0
    aborted: bool = False

    @property
    def queue_wait(self) -> int | None:
        return None if self.admit is None else self.admit - self.arrival

    @property
    def ttft(self) -> int | None:
        """Arrival to first generated token, in decode steps."""
        if not self.token_steps:
            return None
        return self.token_steps[0] - self.arrival

    def itl_gaps(self) -> list[int]:
        """Decode-step gaps between consecutive generated tokens."""
        return [b - a for a, b in zip(self.token_steps, self.token_steps[1:])]


class RollingMonitor:
    """Sliding-window spike/regression monitor (wandblog.py style).

    ``push`` returns True when the sample is a spike (one value beyond
    ``spike_factor`` x the sliding median); ``regressed`` is the current
    drift state (newest half-window median beyond ``regress_factor`` x the
    oldest half's), and ``regressions`` counts its rising edges.  Nothing
    fires before ``min_samples`` -- a median of two requests is noise."""

    def __init__(self, window: int = 32, spike_factor: float = 3.0,
                 regress_factor: float = 1.5, min_samples: int = 8) -> None:
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = window
        self.spike_factor = spike_factor
        self.regress_factor = regress_factor
        self.min_samples = min_samples
        self._buf: collections.deque[float] = collections.deque(maxlen=window)
        self.count = 0
        self.spikes = 0
        self.regressions = 0
        self.regressed = False

    def median(self) -> float | None:
        return percentile(self._buf, 50)

    def push(self, value: float) -> bool:
        value = float(value)
        med = self.median()
        spike = (self.count >= self.min_samples and med is not None
                 and value > self.spike_factor * med)
        self._buf.append(value)
        self.count += 1
        self.spikes += int(spike)
        buf = list(self._buf)
        if len(buf) >= 2 * self.min_samples:
            half = len(buf) // 2
            old = percentile(buf[:half], 50)
            new = percentile(buf[half:], 50)
            now_regressed = new > self.regress_factor * max(old, 1e-9)
            self.regressions += int(now_regressed and not self.regressed)
            self.regressed = now_regressed
        return spike

    def summary(self) -> dict:
        med = self.median()
        return {"window": self.window, "samples": self.count,
                "median": None if med is None else round(med, 3),
                "spikes": self.spikes, "regressions": self.regressions,
                "regressed": self.regressed}


class Telemetry:
    """Per-request lifecycle recorder for one engine.

    The trace rides on the request object itself (``req._trace``, like the
    engine's ``_swap``/``_next`` resume state), so requeues and uid
    collisions cannot cross wires.  Every hook is cheap host-side
    bookkeeping -- no device sync, no effect on decode."""

    def __init__(self, monitor_window: int = 32) -> None:
        self.clock = StepClock()
        self.traces: list[RequestTrace] = []
        self.monitor = RollingMonitor(window=monitor_window)

    def _trace(self, req) -> RequestTrace:
        tr = getattr(req, "_trace", None)
        if tr is None:
            tr = req._trace = RequestTrace(uid=req.uid,
                                           arrival=self.clock.now())
            self.traces.append(tr)
        return tr

    # -- lifecycle hooks (called by ServeEngine / Scheduler) ----------------
    def on_arrival(self, req) -> None:
        """Request entered the wait queue (Scheduler.submit).  A request
        admitted without a scheduler is backdated to its first hook."""
        self._trace(req)

    def on_admit(self, req, resumed: bool = False, shared_tokens: int = 0,
                 swap_in_pages: int = 0, spill_in_pages: int = 0,
                 match_depth_pages: int = 0) -> None:
        tr = self._trace(req)
        if tr.admit is None:
            tr.admit = self.clock.now()
        tr.admissions += 1
        tr.resumes += int(resumed)
        tr.shared_tokens += shared_tokens
        tr.swap_in_pages += swap_in_pages
        tr.spill_in_pages += spill_in_pages
        tr.prefix_match_depth_pages = max(tr.prefix_match_depth_pages,
                                          int(match_depth_pages))

    def on_token(self, req, index: int, at: int | None = None) -> None:
        """Generated token ``index`` was produced this step.  Re-production
        of an already-produced index (a recompute replay) keeps the first
        timestamp: the token could have been streamed then, and the replay
        cost lands in the following tokens' gaps.

        ``at`` backdates the production step: a fused multi-step decode
        run ticks the clock once for the whole run, then attributes each
        token to the step inside the run that actually computed its
        logits (run start + iteration + 1) -- the same integer the
        stepwise path would have recorded."""
        tr = self._trace(req)
        if index == len(tr.token_steps):
            tr.token_steps.append(self.clock.now() if at is None
                                  else int(at))
            if index == 0:
                self.monitor.push(tr.ttft)

    def on_preempt(self, req, swapped: bool) -> None:
        tr = self._trace(req)
        tr.preemptions += 1
        tr.swaps += int(swapped)

    def on_complete(self, req) -> None:
        tr = self._trace(req)
        # the completing decode also computed a speculative next token that
        # will never be appended; drop it from the latency record
        del tr.token_steps[len(req.output):]
        tr.completion = self.clock.now()

    def on_abort(self, req) -> None:
        self._trace(req).aborted = True

    # -- aggregation --------------------------------------------------------
    def request_rows(self) -> list[dict]:
        """Per-request latency table (uid order of arrival)."""
        rows = []
        for t in self.traces:
            gaps = t.itl_gaps()
            rows.append({
                "uid": t.uid, "arrival": t.arrival,
                "queue_wait": t.queue_wait, "ttft": t.ttft,
                "mean_itl": (round(sum(gaps) / len(gaps), 3)
                             if gaps else None),
                "tokens": len(t.token_steps),
                "preemptions": t.preemptions, "swaps": t.swaps,
                "resumes": t.resumes, "shared_tokens": t.shared_tokens,
                "match_depth_pages": t.prefix_match_depth_pages,
                "done": t.completion is not None, "aborted": t.aborted})
        return rows

    def summary(self) -> dict:
        """The SLO summary: exact TTFT/ITL/queue-wait percentiles over
        completed requests (decode-step denominated) plus totals and the
        rolling-monitor state."""
        done = [t for t in self.traces if t.completion is not None]
        ttfts = [t.ttft for t in done if t.ttft is not None]
        waits = [t.queue_wait for t in done if t.queue_wait is not None]
        gaps = [g for t in done for g in t.itl_gaps()]
        return {
            "steps": self.clock.now(),
            "arrived": len(self.traces),
            "completed": len(done),
            "aborted": sum(t.aborted for t in self.traces),
            "preemptions": sum(t.preemptions for t in self.traces),
            "swap_resumes": sum(t.resumes for t in self.traces),
            "swap_in_pages": sum(t.swap_in_pages for t in self.traces),
            "spill_in_pages": sum(t.spill_in_pages for t in self.traces),
            "shared_tokens": sum(t.shared_tokens for t in self.traces),
            "prefix_match_depth_pages": _dist(
                [t.prefix_match_depth_pages for t in done]),
            "ttft_steps": _dist(ttfts),
            "itl_steps": _dist(gaps),
            "queue_wait_steps": _dist(waits),
            "monitor": self.monitor.summary(),
        }
