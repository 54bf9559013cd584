"""Multi-step decode with one host sync per run (a port of
``repro.serve.fused_decode``).

* :func:`sampled_decode_step` -- one decode step with greedy argmax on the
  device, so a single ``int32[B]`` sampled-token vector crosses to the
  host.  The building block of the stepwise path.

* :func:`fused_decode_run` -- up to ``n_steps`` decode steps as one Python
  loop that never reads a device value: each iteration applies the staged
  prefetch column, advances ``lengths`` for the active slots, runs the
  model's decode step (write-masked to the active slots), samples greedily
  into a ``[cap, B]`` buffer and feeds the token back.  The reference's
  ``lax.while_loop`` exits after the iteration that FED ``eos_id``; here a
  device-side ``alive`` flag predicates every later iteration out instead:
  its writes are masked off and it changes no pages, lengths, vm tables or
  buffer rows.  ``n_done`` counts the iterations run while alive, which is
  the reference loop's exit ``k``.  The buffer and ``n_done`` come back in
  one transfer.

The caller makes the run control-plane free (the engine stages it against
the BlockManager first): staged ``(lpage, frame)`` columns are the device
half of boundary prefetches whose allocator half already happened.
"""
from __future__ import annotations

import torch


def greedy(model, logits: torch.Tensor) -> torch.Tensor:
    """int32[B] argmax over the real (unpadded) vocabulary; the first
    maximum wins, as in the reference."""
    return logits[:, :model.cfg.vocab_size].argmax(-1).to(torch.int32)


@torch.no_grad()
def sampled_decode_step(model, tokens, cache, lengths, write_mask):
    """One decode step with greedy sampling on the device.  Returns
    ``(sampled, logits, cache)``; the cache's pages are updated in place."""
    logits, cache = model.decode_step(tokens, cache, lengths,
                                      write_mask=write_mask)
    return greedy(model, logits), logits, cache


def _apply_staged(vm: dict, lp: torch.Tensor, fm: torch.Tensor,
                  alive: torch.Tensor) -> dict:
    """``block_table[b, lp[b]] = fm[b]`` and ``frame_lpage[fm[b]] = lp[b]``
    for the rows whose entry is staged (>= 0) while the run is alive.  Rows
    with nothing to apply are sent to a dump element one past the end: a
    raw -1 would wrap to the last row."""
    bt, fl = vm["block_table"], vm["frame_lpage"]
    b, n_lp = bt.shape
    n_frames = fl.shape[0]
    rows = torch.arange(b, device=bt.device)
    bt_ix = torch.where(alive & (lp >= 0), rows * n_lp + lp, b * n_lp)
    fl_ix = torch.where(alive & (fm >= 0), fm, n_frames)
    bt_ext = torch.cat([bt.reshape(-1), bt.new_zeros(1)])
    fl_ext = torch.cat([fl, fl.new_zeros(1)])
    bt_ext[bt_ix.long()] = fm
    fl_ext[fl_ix.long()] = lp
    return {**vm, "block_table": bt_ext[:-1].reshape(b, n_lp),
            "frame_lpage": fl_ext[:-1]}


@torch.no_grad()
def fused_decode_run(model, cap: int, tokens, cache, lengths, active,
                     n_steps: int, eos_id: int, staged_lp=None,
                     staged_frame=None):
    """Run up to ``n_steps`` decode steps with no host sync inside.

    Args:
      model: the :class:`Model`.
      cap: rows of the sampled-token buffer (``EngineConfig.max_fused_steps``).
      tokens: ``int32[B, 1]`` the token each active slot feeds first.
      cache: the KV cache (pages updated in place; ``cache["vm"]`` replaced
        by the tables with the applied staged columns).
      lengths: ``int32[B]`` current sequence lengths.
      active: ``bool[B]`` which slots decode; also the write mask.
      n_steps: iteration bound (host int, <= cap).
      eos_id: EOS token (-1: none, so no token matches).
      staged_lp / staged_frame: ``int32[B, cap]`` staged prefetch mappings
        (-1 = nothing), column ``k`` applied at the top of iteration ``k``;
        ignored when the cache carries no ``vm`` tables (batch layout).

    Returns ``(buf, n_done, cache, lengths)`` with ``buf`` and ``n_done`` on
    the host: the ``int32[cap, B]`` numpy buffer (row k = tokens sampled by
    iteration k) and the number of iterations that ran."""
    dev = lengths.device
    inc = active.to(lengths.dtype)
    buf = torch.zeros((cap, tokens.shape[0]), dtype=torch.int32, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    n_done = torch.zeros((), dtype=torch.int32, device=dev)
    toks = tokens
    for k in range(n_steps):
        if staged_lp is not None and "vm" in cache:
            cache["vm"] = _apply_staged(cache["vm"], staged_lp[:, k],
                                        staged_frame[:, k], alive)
        lengths = lengths + inc * alive
        sampled, _, cache = sampled_decode_step(model, toks, cache, lengths,
                                                active & alive)
        buf[k] = torch.where(alive, sampled, buf[k])
        n_done = n_done + alive.to(torch.int32)
        # the stepwise engine completes a slot whose FED token is EOS;
        # every iteration after the one that fed it is predicated out
        stop = (active & (toks[:, 0] == eos_id)).any()
        toks = torch.where((active & alive)[:, None], sampled[:, None], toks)
        alive = alive & ~stop
    host = torch.cat([buf.reshape(-1), n_done.reshape(1)]).cpu().numpy()
    return host[:-1].reshape(cap, -1), int(host[-1]), cache, lengths
