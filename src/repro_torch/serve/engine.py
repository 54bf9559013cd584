"""Batched serving engine: continuous batching over fixed decode slots (a
port of ``repro.serve.engine``).

The engine owns a fixed-capacity decode batch (B slots).  Requests are
admitted by the scheduler into free slots, prefilled one token at a time
through the decode step (their KV written into the slot's frames), then
advanced together by the shared decode step.

With ``kv_layout="batch"`` every slot owns a fixed [Hkv, max_len, hd] row
of each layer's K/V and there is no frame management at all: no
BlockManager, no sharing, no preemption (``blocks is None``).  A Mamba2
layer keeps per-slot recurrent state (conv window, SSD state) in every
layout: zeroed when a slot is reused, carried in the swap record, and the
reason a model with such layers shares no prefixes and retains no pages.
With the paged layouts, KV frame ownership and residency sit behind one
refcounted :class:`repro_torch.emem_vm.BlockManager`: every sequence goes
through a logical->frame block table that rides in the cache
(``cache["vm"]``) into the paged-decode kernels.  The two paged ``kv_layout`` values are
allocation policies:

  * ``"paged"``  -- *reserved*: every slot permanently owns its worst-case
    ``max_pages`` frames;
  * ``"pooled"`` -- *on-demand*: frames come from the shared pool as each
    sequence grows and return at completion, with prefix sharing and
    copy-on-write (shared pages are read-only through ``frame_ro``),
    swap-preemption to a host tier (and on to a spill tier), recompute as
    the last resort, prefix retention and next-page prefetch.

The engine carries no residency branching: it calls ``evict_seq`` /
``restore_seq`` / ``release_seq`` and applies the page moves the
BlockManager decides on through the :class:`repro_torch.emem_vm.PageIO`
callbacks bound at construction.

**Fused multi-step decode.**  Before each ``step()`` the engine caps the
run at the first budget / ``max_len`` completion, stages it against the
BlockManager (pre-allocating the boundary prefetches the stepwise loop
would have granted) and runs the plan with
:func:`repro_torch.serve.fused_decode.fused_decode_run`: one host sync per
run, greedy sampling on the device.  The per-step bookkeeping is then
replayed host-side from the sampled-token buffer, byte for byte what the
stepwise path would have recorded.  ``EngineConfig.max_fused_steps=1``
reproduces step-at-a-time dispatch exactly.

Host buffers are always COPIED to the device (``torch.tensor``): the
engine mutates its numpy ``lengths``/token batches in place, and
``torch.from_numpy`` would share that memory with an in-flight step.

``ServeEngine`` is a context manager: ``with ServeEngine(...) as eng:``
runs the shutdown leak detector on every exit path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.emem_vm import BlockManager, OutOfFrames, PageIO
from repro_torch.models.model import Model
from repro_torch.parallel.paged_attention import (cow_copy_pages,
                                                  read_frame_pages,
                                                  read_slot_state,
                                                  slot_state_entries,
                                                  write_frame_pages,
                                                  write_slot_state)
from repro_torch.serve.fused_decode import (fused_decode_run,
                                            sampled_decode_step)
from repro_torch.serve.telemetry import Telemetry


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4
    max_len: int = 256
    eos_id: int | None = None
    #: "swap" parks preempted sequences' pages on host and resumes them with
    #: a swap-in; "recompute" requeues and re-prefills.
    preempt_mode: str = "swap"
    #: device frames the BlockManager may keep holding completed prompts'
    #: prefix pages (0 disables the retention pool)
    retain_frames: int = 0
    #: host backing-store frames (None: one per device frame)
    host_frames: int | None = None
    #: third-tier spill-store frames (0 disables the spill tier)
    spill_frames: int = 0
    #: directory backing the spill store (None: in-memory bytes)
    spill_path: str | None = None
    #: sliding-window size of the rolling TTFT monitor
    telemetry_window: int = 32
    #: upper bound on the decode steps fused into one run between
    #: control-plane events; ``1`` reproduces step-at-a-time dispatch
    max_fused_steps: int = 8
    #: prompt prefix index behind the BlockManager: "tree" or "linear"
    prefix_index: str = "tree"


class ServeEngine:
    def __init__(self, model: Model, ecfg: EngineConfig):
        if ecfg.preempt_mode not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt_mode {ecfg.preempt_mode!r}")
        if ecfg.max_fused_steps < 1:
            raise ValueError(
                f"max_fused_steps must be >= 1, got {ecfg.max_fused_steps}")
        if ecfg.prefix_index not in ("tree", "linear"):
            raise ValueError(f"unknown prefix_index {ecfg.prefix_index!r}")
        self.model = model
        self.device = model.device
        self.ecfg = ecfg
        self.cache = model.init_cache(ecfg.slots, ecfg.max_len)
        self.lengths = torch.zeros((ecfg.slots,), dtype=torch.int32,
                                   device=self.device)
        self.slot_req: list[Request | None] = [None] * ecfg.slots
        self.budget = np.zeros(ecfg.slots, np.int64)
        #: requests preempted since the last drain (scheduler requeues them)
        self.preempted: list[Request] = []
        #: requests completed since the last drain, wherever the completion
        #: happened (a decode step or an admission-time preemption)
        self.completed_reqs: list[Request] = []
        self._admit_seq = np.zeros(ecfg.slots, np.int64)  # admission order
        self._admit_counter = 0
        #: positions per slot whose KV writes have committed (the decode
        #: ran); a swap-out must only trust committed KV
        self._kv_committed = np.zeros(ecfg.slots, np.int64)
        self._shutdown_stats: dict | None = None
        #: per-request SLO telemetry; its StepClock ticks once per decode
        #: step, so every latency is decode-step denominated
        self.metrics = Telemetry(monitor_window=ecfg.telemetry_window)
        self.counters = {"admitted": 0, "completed": 0, "preempted": 0,
                         "swapped": 0, "swap_resumed": 0, "aborted": 0,
                         "decode_steps": 0, "dispatches": 0,
                         "shared_prompt_tokens": 0, "leaked_frames": 0,
                         "score_cache_hits": 0}
        cfg = model.cfg
        self.blocks = None
        if cfg.kv_layout not in ("paged", "pooled"):
            return                   # batch layout: no frame management
        self.page_slots = cfg.kv_page_slots
        self.max_lpages = -(-ecfg.max_len // self.page_slots)
        if cfg.kv_layout == "pooled":
            policy = "on_demand"
            self.n_frames = cfg.kv_pool_pages or ecfg.slots * self.max_lpages
        else:
            policy = "reserved"
            self.n_frames = ecfg.slots * self.max_lpages
        # prefix sharing skips prefill of shared tokens, which is only
        # sound when every layer's per-token state lives in the shared KV
        # pages (no recurrent SSM state to rebuild); swap does not care --
        # evicted slots' recurrent state rides the swap record.  Retention
        # rides on prefix sharing, so asking for it on a model that cannot
        # share is an error, not a silent no-op.
        attn_only = all(cfg.layer_kind(i) == "attn"
                        for i in range(cfg.layer_period))
        if ecfg.retain_frames > 0 and not attn_only:
            raise ValueError(
                "retain_frames requires an attention-only model: retained "
                "pages hold KV only, and an admission that skips prefill "
                "cannot rebuild recurrent (SSM) state")
        self.blocks = BlockManager(
            self.n_frames, ecfg.slots, self.max_lpages, self.page_slots,
            policy=policy, share_prefixes=attn_only,
            n_host_frames=ecfg.host_frames,
            retain_frames=ecfg.retain_frames,
            swap_enabled=ecfg.preempt_mode == "swap",
            n_spill_frames=ecfg.spill_frames,
            spill_path=ecfg.spill_path,
            prefix_index=ecfg.prefix_index)
        self.blocks.page_io = PageIO(
            read=lambda frames: read_frame_pages(self.cache, frames),
            write=self._apply_frame_writes)
        self.blocks.dirty = True     # push the initial (empty) tables

    # -- context manager ------------------------------------------------------
    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        """Run the shutdown leak detector on every exit path.  When the body
        raised, active requests are aborted first and a secondary shutdown
        failure is swallowed so the original exception propagates."""
        try:
            self.shutdown(abort=exc_type is not None)
        except Exception:
            if exc_type is None:
                raise
        return False

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def _host_lengths(self) -> np.ndarray:
        return self.lengths.cpu().numpy().copy()

    def _decode(self, toks: np.ndarray, write_mask: np.ndarray):
        """One decode step with greedy sampling on the device.  Returns the
        host ``int32[B]`` sampled tokens -- the one transfer, and the sync,
        of the step."""
        sampled, _, self.cache = sampled_decode_step(
            self.model, self._to_device(toks), self.cache, self.lengths,
            self._to_device(write_mask))
        sampled = sampled.cpu().numpy()
        self.counters["decode_steps"] += 1
        self.counters["dispatches"] += 1
        self.metrics.clock.tick()
        return sampled

    # -- frame management (via the BlockManager) ----------------------------
    def _apply_frame_writes(self, assignments) -> None:
        """PageIO write callback: scatter host payloads into device frames."""
        self.cache = write_frame_pages(self.cache, assignments)

    def _tokens_for(self, req: Request) -> np.ndarray:
        """The tokens a (re-)admission must account for: the prompt plus any
        tokens generated before a preemption.  An empty prompt becomes one
        implicit BOS so ``logits`` is always bound."""
        toks = np.asarray(req.prompt, np.int32).ravel()
        if req.output:
            toks = np.concatenate([toks,
                                   np.asarray(req.output, np.int32)])
        return toks if len(toks) else np.zeros(1, np.int32)

    def _swap_tag(self, req: Request):
        swap = getattr(req, "_swap", None)
        return swap["tag"] if swap is not None else None

    def _grow(self, slot: int, new_len: int, lengths: np.ndarray) -> bool:
        """Back position ``new_len - 1`` of ``slot`` with a writable frame,
        applying any copy-on-write and preempting the youngest sequence on
        pool exhaustion.  Returns False iff ``slot`` itself was preempted."""
        if self.blocks is None:
            return True
        while True:
            try:
                copies = self.blocks.ensure_writable(slot, new_len - 1)
            except OutOfFrames:
                victim = max(
                    (i for i, r in enumerate(self.slot_req) if r is not None),
                    key=lambda s: self._admit_seq[s])
                self._preempt(victim, lengths)
                if victim == slot:
                    return False
                continue
            if copies:
                self.cache = cow_copy_pages(self.cache, copies)
            return True

    def _is_complete(self, req: Request, cur_len: int) -> bool:
        """The post-decode completion conditions, evaluable host-side: used
        at preemption so a request evicted right after its final token is
        finished, not re-run."""
        hit_eos = (self.ecfg.eos_id is not None
                   and req.output and req.output[-1] == self.ecfg.eos_id)
        return (len(req.output) >= req.max_new_tokens or hit_eos
                or cur_len >= self.ecfg.max_len - 1)

    def _preempt(self, slot: int, lengths: np.ndarray) -> None:
        """Evict ``slot``.  The BlockManager decides residency: with the swap
        tier available the pages move to the host store and re-admission
        swaps them back in; otherwise the frames are freed and the generated
        tokens ride along as a prompt extension so the greedy re-run is
        token-identical.  A request that had already produced its last
        token completes instead of requeueing."""
        req = self.slot_req[slot]
        cur_len = int(lengths[slot])
        committed = int(self._kv_committed[slot])
        self.slot_req[slot] = None
        self.budget[slot] = 0
        lengths[slot] = 0
        self._kv_committed[slot] = 0
        if self._is_complete(req, cur_len):
            self._release(slot)
            req.done = True
            self.counters["completed"] += 1
            self.completed_reqs.append(req)
            self.metrics.on_complete(req)
            return
        swapped = False
        if self.blocks is not None:
            tag = id(req)
            if self.blocks.evict_seq(slot, tag) is not None:
                # resume state: committed KV length, the pending next
                # token, and the slot's recurrent (SSM) state
                req._swap = {"tag": tag, "committed": committed,
                             "next": getattr(req, "_next", None),
                             "slot_state": read_slot_state(self.cache, slot)}
                self.counters["swapped"] += 1
                swapped = True
            else:
                self.blocks.release_seq(slot, completed=False)
        self.counters["preempted"] += 1
        self.metrics.on_preempt(req, swapped=swapped)
        self.preempted.append(req)

    def drain_preempted(self) -> list[Request]:
        out, self.preempted = self.preempted, []
        return out

    def drain_completed(self) -> list[Request]:
        """Requests completed since the last drain."""
        out, self.completed_reqs = self.completed_reqs, []
        return out

    def _release(self, slot: int) -> None:
        if self.blocks is not None:
            self.blocks.release_seq(slot, completed=True)

    def _sync_vm(self) -> None:
        """Push the BlockManager tables into the cache if they changed."""
        if self.blocks is not None and self.blocks.dirty:
            self.cache["vm"] = {k: self._to_device(v)
                                for k, v in self.blocks.tables().items()}
            self.blocks.dirty = False

    def telemetry(self) -> dict:
        """Live per-request SLO telemetry summary (decode-step
        denominated); also folded into ``shutdown()``'s stats."""
        return self.metrics.summary()

    def shutdown(self, abort: bool = False) -> dict:
        """Leak detector: at shutdown every frame reference -- device, host
        and spill tier -- must have been released.  Idempotent: a second call
        returns the recorded stats.  ``abort=True`` releases still-active
        requests instead of refusing.  Returns the engine counters plus the
        ``"telemetry"`` section; raises if a sequence is still active or a
        frame leaked."""
        if self._shutdown_stats is not None:
            return self._shutdown_stats
        active = [r.uid for r in self.slot_req if r is not None]
        if active and not abort:
            raise RuntimeError(f"shutdown with active requests {active}")
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            self.slot_req[i] = None
            self.counters["aborted"] += 1
            self.metrics.on_abort(r)
            if self.blocks is not None:
                self.blocks.release_seq(i, completed=False)
        leaked = self.blocks.shutdown() if self.blocks is not None else 0
        tiers = (self.blocks.leak_counts() if self.blocks is not None
                 else {"device": 0, "host": 0, "spill": 0})
        self.counters["leaked_frames"] = leaked
        stats = dict(self.counters)
        stats.update({f"leaked_{t}_frames": n for t, n in tiers.items()})
        if self.blocks is not None:
            stats.update(self.blocks.counters)
            stats["shared_prompt_tokens"] = \
                self.blocks.counters["shared_tokens"]
        stats["telemetry"] = self.metrics.summary()
        if leaked:
            raise RuntimeError(
                f"KV frame leak at shutdown: {leaked} frames still "
                f"referenced ({tiers}; {stats})")
        self._shutdown_stats = stats
        return stats

    # -- admission ----------------------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def admission_cost(self, req: Request):
        """Residency cost terms for admitting ``req`` right now (an
        :class:`repro_torch.emem_vm.AdmissionCost`), or None without a
        BlockManager: the batch layout carries no residency signal, so any
        score built on top degenerates to FIFO."""
        if self.blocks is None:
            return None
        return self.blocks.admission_cost(self._tokens_for(req),
                                          tag=self._swap_tag(req))

    def can_admit(self, req: Request, cost=None) -> bool:
        """Admission control: room for at least one generated token under
        max_len, a free slot, and (optimistically) the pages the admission
        immediately needs.  ``cost`` may pass an :meth:`admission_cost`
        result already in hand."""
        toks = self._tokens_for(req)
        if len(toks) > self.ecfg.max_len - 2:
            return False
        if not self.free_slots():
            return False
        if self.blocks is None:
            return True
        if cost is None:
            cost = self.blocks.admission_cost(toks, tag=self._swap_tag(req))
        return cost.admissible

    def admit(self, req: Request, slot: int) -> None:
        """Admit a request into a slot.

        A swapped-out request *resumes*: its pages swap back in and only
        tokens beyond the committed KV are decoded.  A fresh request
        prefills token by token through the decode path; prompt pages shared
        with the retention pool or a live sequence are skipped (the last
        prompt token always re-runs to bind the next-token logits; its write
        to a still-shared frame is dropped by the kernel's ``frame_ro``
        test)."""
        assert self.slot_req[slot] is None
        if not self.can_admit(req):      # before any state is mutated
            raise RuntimeError(
                "inadmissible request (prompt too long for max_len, or no "
                "free-frame headroom)")
        toks = self._tokens_for(req)
        self.slot_req[slot] = req
        self.budget[slot] = req.max_new_tokens - len(req.output)
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        swap = getattr(req, "_swap", None)
        if swap is not None and self.blocks is not None \
                and self.blocks.has_swap(swap["tag"]):
            # no _reset_slot: the restore overwrites every per-slot field it
            # would zero (lengths, committed KV, the whole slot state)
            swap_in0 = self.blocks.counters["swap_in_pages"]
            spill_in0 = self.blocks.counters["spill_in_pages"]
            self.blocks.restore_seq(slot, swap["tag"], toks)
            self.metrics.on_admit(
                req, resumed=True,
                swap_in_pages=self.blocks.counters["swap_in_pages"]
                - swap_in0,
                spill_in_pages=self.blocks.counters["spill_in_pages"]
                - spill_in0)
            write_slot_state(self.cache, slot, swap["slot_state"])
            start = int(swap["committed"])
            req._next = swap["next"]
            del req._swap
            self.counters["swap_resumed"] += 1
            lengths = self._host_lengths()
            lengths[slot] = start
            self.lengths = self._to_device(lengths)
            self._kv_committed[slot] = start
            if start >= len(toks):
                # fully committed: KV, recurrent state and the pending next
                # token were all restored -- nothing to decode
                self.counters["admitted"] += 1
                return
        else:
            self._reset_slot(slot)
            shared = 0
            if self.blocks is not None:
                shared = self.blocks.begin_seq(slot, toks)
                self.counters["shared_prompt_tokens"] += shared
            self.metrics.on_admit(
                req, shared_tokens=shared,
                match_depth_pages=-(-shared // self.page_slots)
                if self.blocks is not None else 0)
            start = min(shared, len(toks) - 1)
        mask = np.zeros(self.ecfg.slots, bool)
        mask[slot] = True                # only this slot commits KV writes
        lengths = self._host_lengths()
        tok_batch = np.zeros((self.ecfg.slots, 1), np.int32)
        for t in range(start, len(toks)):
            lengths[slot] = t + 1
            if not self._grow(slot, t + 1, lengths):
                # preempted mid-prefill; requeued for retry
                self.lengths = self._to_device(lengths)
                return
            self.lengths = self._to_device(lengths)
            tok_batch[slot, 0] = toks[t]
            self._sync_vm()
            sampled = self._decode(tok_batch, mask)
            self._kv_committed[slot] = t + 1
        req._next = int(sampled[slot])
        self.metrics.on_token(req, len(req.output))
        self.counters["admitted"] += 1

    def _reset_slot(self, slot: int) -> None:
        lengths = self._host_lengths()
        lengths[slot] = 0
        self.lengths = self._to_device(lengths)
        self._kv_committed[slot] = 0
        # per-slot state (recurrent SSM rows, batch-layout K/V) is zeroed:
        # recurrent state is cumulative, so a reused slot must not carry the
        # previous tenant's state into the new sequence
        for _, entry in slot_state_entries(self.cache):
            for t in entry.values():
                t[:, slot] = 0

    # -- decode -------------------------------------------------------------
    def _fused_horizon(self, order, lengths, max_steps: int | None) -> int:
        """Completion cap on a fused run: steps until the first active slot
        completes on budget or ``max_len``, bounded by ``max_fused_steps``
        and ``max_steps`` (the scheduler's external bound).  EOS cannot be
        bounded host-side -- the fused run predicates itself out on it."""
        cap = self.ecfg.max_fused_steps
        if max_steps is not None:
            cap = min(cap, max_steps)
        for i in order:
            if cap <= 1:
                return 1
            cap = min(cap, int(self.budget[i]),
                      self.ecfg.max_len - 1 - int(lengths[i]))
        return max(cap, 1)

    def _step_fused(self, order, horizon: int, plan=None) -> int:
        """Run ``horizon`` decode steps (fewer on an EOS exit) with one host
        sync, then replay the per-step bookkeeping host-side from the
        sampled-token buffer.  The staged ``plan``'s (lpage, frame)
        mappings ride into the run as per-iteration columns; afterwards the
        plan is committed for the steps that actually ran."""
        cap = int(self.ecfg.max_fused_steps)
        active = np.zeros(self.ecfg.slots, bool)
        toks = np.zeros((self.ecfg.slots, 1), np.int32)
        staged_lp = np.full((self.ecfg.slots, cap), -1, np.int32)
        staged_fm = np.full((self.ecfg.slots, cap), -1, np.int32)
        lengths0 = self._host_lengths()
        for i in order:
            active[i] = True
            toks[i, 0] = self.slot_req[i]._next
        if plan is not None:
            for st in plan.allocs:
                if st.k_hit < horizon:   # applied by iteration k_hit's body;
                    staged_lp[st.seq, st.k_hit] = st.lpage
                    staged_fm[st.seq, st.k_hit] = st.frame
                # k_hit == horizon stagings commit host-side only -- the
                # dirty flag re-syncs the device tables before the next
                # dispatch, exactly like a stepwise trailing prefetch
        eos = -1 if self.ecfg.eos_id is None else int(self.ecfg.eos_id)
        self._sync_vm()
        buf, n, self.cache, self.lengths = fused_decode_run(
            self.model, cap, self._to_device(toks), self.cache, self.lengths,
            self._to_device(active), horizon, eos,
            self._to_device(staged_lp), self._to_device(staged_fm))
        if plan is not None:
            self.blocks.commit_fused_run(plan, n)
        self.counters["decode_steps"] += n
        self.counters["dispatches"] += 1
        c0 = self.metrics.clock.now()
        self.metrics.clock.tick(n)
        # token attribution: iteration k fed the pending ``_next`` (k == 0)
        # or buf[k-1], and its decode (at clock c0 + k + 1) sampled buf[k]
        for k in range(n):
            for i in order:
                req = self.slot_req[i]
                req.output.append(int(toks[i, 0]) if k == 0
                                  else int(buf[k - 1, i]))
                self.metrics.on_token(req, len(req.output), at=c0 + k + 1)
        for i in sorted(order):          # stepwise parity: slot-index order
            req = self.slot_req[i]
            new_len = int(lengths0[i]) + n
            self._kv_committed[i] = new_len
            req._next = int(buf[n - 1, i])
            self.budget[i] -= n
            hit_eos = (self.ecfg.eos_id is not None
                       and req.output and req.output[-1] == self.ecfg.eos_id)
            if self.budget[i] <= 0 or hit_eos or \
                    new_len >= self.ecfg.max_len - 1:
                req.done = True
                self.slot_req[i] = None
                self.counters["completed"] += 1
                self.completed_reqs.append(req)
                self.metrics.on_complete(req)
                self._kv_committed[i] = 0
                self._release(i)
        return n

    def step(self, max_steps: int | None = None) -> int:
        """Advance every active slot by one decode step -- or, when the
        fused horizon allows, by a whole fused run of them.  Returns the
        number of decode steps executed (0 when idle).

        ``max_steps`` bounds the fused run externally (the trace replayer
        caps it at the next arrival).  On the stepwise path, frame growth
        runs oldest-sequence-first so that on pool exhaustion the youngest
        sequences are preempted, and the next page boundary each survivor
        will cross is prefetched one token early."""
        order = sorted((i for i, r in enumerate(self.slot_req)
                        if r is not None),
                       key=lambda s: self._admit_seq[s])
        if not order:
            return 0
        lengths_np = self._host_lengths()
        horizon = self._fused_horizon(order, lengths_np, max_steps)
        plan = None
        if horizon > 1 and self.blocks is not None:
            plan = self.blocks.stage_fused_run(
                order, [int(lengths_np[i]) for i in order], horizon)
            if plan.n <= 1:              # immediate growth/COW: stepwise
                self.blocks.cancel_fused_run(plan)
                plan, horizon = None, 1
            else:
                horizon = plan.n
        if horizon > 1:
            return self._step_fused(order, horizon, plan)
        toks = np.zeros((self.ecfg.slots, 1), np.int32)
        lengths = lengths_np.copy()
        for i in order:
            req = self.slot_req[i]
            if req is None:              # preempted by an earlier grow
                continue
            req.output.append(req._next)
            toks[i, 0] = req._next
            lengths[i] += 1
            if self._grow(i, int(lengths[i]), lengths) and \
                    self.slot_req[i] is not None and self.blocks is not None:
                self.blocks.prefetch(i, int(lengths[i]))
        self.lengths = self._to_device(lengths)
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        mask = np.zeros(self.ecfg.slots, bool)
        mask[active] = True
        self._sync_vm()
        sampled = self._decode(toks, mask)
        for i in active:
            self._kv_committed[i] = int(lengths[i])
            req = self.slot_req[i]
            req._next = int(sampled[i])
            self.metrics.on_token(req, len(req.output))
            self.budget[i] -= 1
            hit_eos = (self.ecfg.eos_id is not None
                       and req.output and req.output[-1] == self.ecfg.eos_id)
            if self.budget[i] <= 0 or hit_eos or \
                    int(lengths[i]) >= self.ecfg.max_len - 1:
                req.done = True
                self.slot_req[i] = None
                self.counters["completed"] += 1
                self.completed_reqs.append(req)
                self.metrics.on_complete(req)
                self._kv_committed[i] = 0
                self._release(i)
        return 1
