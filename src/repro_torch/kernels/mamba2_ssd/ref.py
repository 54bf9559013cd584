"""Plain-torch oracles for the Mamba2 SSD (state-space duality) scan: a
port of ``repro.kernels.mamba2_ssd.ref``.  :func:`ssd_chunked` is K5's
plain version, and what ``ops.ssd`` runs on CPU tensors.

Discretization (Mamba-2, arXiv:2405.21060):
    abar_t = exp(dt_t * A_h)                     (scalar per token, head)
    h_t    = abar_t * h_{t-1} + dt_t * (B_t outer x_t)   (state [N, P])
    y_t    = C_t . h_t + D_h * x_t

Shapes:
    x:  [Bt, S, H, P]   (P = head dim)
    dt: [Bt, S, H]      (post-softplus, > 0)
    A:  [H]             (negative)
    B, C: [Bt, S, G, N] (G groups; head h uses group h // (H // G))
    D:  [H]
Each returns y [Bt, S, H, P] in x's dtype and the final state
[Bt, H, N, P] in f32.  The reference's optional initial state ``h0`` is
left out: no caller of the port passes one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _expand_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """[..., G, N] (groups on dim 2) -> [..., H, N] by repeating groups
    over heads."""
    return t.repeat_interleave(h // t.shape[2], dim=2)


def ssd_scan(x, dt, A, B, C, D):
    """Sequential reference: one recurrence step per position."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    Bh = _expand_groups(B, h).float()              # [Bt, S, H, N]
    Ch = _expand_groups(C, h).float()
    xf, dtf = x.float(), dt.float()
    state = torch.zeros((bt, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        abar = torch.exp(dtf[:, t] * A[None, :])   # [Bt, H]
        upd = torch.einsum("bhn,bhp->bhnp", Bh[:, t],
                           xf[:, t] * dtf[:, t, :, None])
        state = state * abar[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1) + xf * D[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked reference -- the same math the kernel implements.

    Any S is taken: the tail chunk is padded with dt = 0 (and x = B = C =
    0), so a padded step has abar = exp(0) = 1 and injects nothing; the
    final state is exact and the padded rows of y are dropped.  (The
    reference asserts ``S % chunk == 0``.)"""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    Bh = _expand_groups(B, h).float()
    Ch = _expand_groups(C, h).float()
    xf, dtf = x.float(), dt.float()
    if pad:
        xf, Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bh, Ch))
        dtf = F.pad(dtf, (0, 0, 0, pad))

    # reshape to chunks: [Bt, nc, Q, H, ...]
    xc = xf.reshape(bt, nc, chunk, h, p)
    dtc = dtf.reshape(bt, nc, chunk, h)
    bc = Bh.reshape(bt, nc, chunk, h, n)
    cc = Ch.reshape(bt, nc, chunk, h, n)

    loga = dtc * A[None, None, None, :]             # [Bt, nc, Q, H]
    L = torch.cumsum(loga, dim=2)                   # inclusive

    # intra-chunk: y[t] = sum_{tau<=t} exp(L_t - L_tau) dt_tau (C_t.B_tau) x_tau
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    diff = torch.where(mask[None, None, :, :, None],
                       L[:, :, :, None, :] - L[:, :, None, :, :], -1e30)
    M = torch.exp(diff)
    CB = torch.einsum("bcthn,bcshn->bctsh", cc, bc)  # t=query, s=key
    y_intra = torch.einsum("bctsh,bcsh,bcshp->bcthp", CB * M, dtc, xc)

    # inter-chunk state recurrence
    state = torch.zeros((bt, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        y_inter = torch.exp(L[:, c])[..., None] * torch.einsum(
            "bthn,bhnp->bthp", cc[:, c], state)
        ys.append(y_intra[:, c] + y_inter)
        w = torch.exp(L[:, c, -1:, :] - L[:, c]) * dtc[:, c]   # [Bt, Q, H]
        upd = torch.einsum("bthn,bthp->bhnp", bc[:, c],
                           xc[:, c] * w[..., None])
        state = state * torch.exp(L[:, c, -1])[:, :, None, None] + upd
    y = torch.stack(ys, dim=1).reshape(bt, nc * chunk, h, p)[:, :s]
    y = y + xf[:, :s] * D[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, A, B, C, D, state):
    """Single-token recurrent step (serving).

    x: [Bt, H, P]; dt: [Bt, H]; B, C: [Bt, G, N]; state: [Bt, H, N, P].
    Returns (y [Bt, H, P], new_state)."""
    h = x.shape[1]
    Bh = B.repeat_interleave(h // B.shape[1], dim=1).float()
    Ch = C.repeat_interleave(h // C.shape[1], dim=1).float()
    xf, dtf = x.float(), dt.float()
    abar = torch.exp(dtf * A[None, :])
    upd = torch.einsum("bhn,bhp->bhnp", Bh, xf * dtf[..., None])
    state = state * abar[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, state) + xf * D[None, :, None]
    return y.to(x.dtype), state
