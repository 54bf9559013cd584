"""Mamba2 (SSD) block: in-proj, causal conv, selective scan, gated norm (a
port of ``repro.models.ssm``).

Follows the Mamba-2 architecture (arXiv:2405.21060): a single input
projection produces [z | xBC | dt]; a depthwise causal conv runs over the
xBC channels; the SSD scan uses the chunked state-space-duality algorithm
(:mod:`repro_torch.kernels.mamba2_ssd`); output is gated-RMS-normed and
projected back.

``attn_impl="pallas"`` sends the scan through ``ops.ssd`` (K5 on CUDA
tensors, its plain version on CPU ones), which returns the final state and
takes any length; ``"ref"`` runs K5's plain version on every device (as
attention's ``"ref"`` runs K3's), the same chunking as the kernel; every
other impl runs :func:`_ssd_chunk_scan`, the reference's per-chunk loop
with its largest-divisor chunk (the reference sends ``"ref"`` there too).
The reference's pallas branch drops the state (``state = None``), so its
prefill leaves no recurrent state for decode: the port returns it.  The
decode step stays plain torch on every device, as the reference keeps it
outside any kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDef, rms_norm


def ssm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    return {
        "w_in": ParamDef((d, 2 * di + 2 * g * n + h)),
        "conv_w": ParamDef((cfg.ssm_conv, conv_ch),
                           scale=cfg.ssm_conv ** -0.5),
        "conv_b": ParamDef((conv_ch,), "zeros"),
        "a_log": ParamDef((h,), "ssm_a"),
        "dt_bias": ParamDef((h,), "ssm_dt"),
        "d_skip": ParamDef((h,), "ones"),
        "norm_w": ParamDef((di,), "ones"),
        "w_out": ParamDef((di, d)),
    }


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * gn]
    dt = zxbcdt[..., 2 * di + 2 * gn:]
    return z, xbc, dt


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, C]; w: [K, C]: the K - 1 positions
    before the first are zeros, as the reference's ``lax.conv`` pads."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))           # [B, C, S + K - 1]
    out = F.conv1d(xp, w.T[:, None, :], groups=c)        # [B, C, S]
    return out.transpose(1, 2) + b


def _ssd_chunk_scan(cfg: ModelConfig, x, dt, A, B, C, D):
    """Chunked SSD as a loop over chunks, the reference's ``lax.scan``.

    x: [Bt, S, H, P]; dt: [Bt, S, H]; B/C: [Bt, S, G, N].
    Returns (y, final_state [Bt, H, N, P])."""
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(cfg.ssd_chunk, s)
    while s % q:          # largest divisor of s not exceeding the chunk size
        q -= 1
    nc = s // q
    hpg = h // g
    xf = x.float().reshape(bt, nc, q, h, p)
    dtf = dt.float().reshape(bt, nc, q, h)
    Bf = B.float().reshape(bt, nc, q, g, n)
    Cf = C.float().reshape(bt, nc, q, g, n)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((bt, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc = xf[:, c], dtf[:, c]                 # [Bt,q,H,P], [Bt,q,H]
        bh = Bf[:, c].repeat_interleave(hpg, dim=2)   # [Bt,q,H,N]
        ch = Cf[:, c].repeat_interleave(hpg, dim=2)
        lcum = torch.cumsum(dtc * A[None, None, :], dim=1)   # [Bt,q,H]
        diff = torch.where(tri[None, :, :, None],
                           lcum[:, :, None, :] - lcum[:, None, :, :], -1e30)
        m = torch.exp(diff)
        cb = torch.einsum("bthn,bshn->btsh", ch, bh)
        y = torch.einsum("btsh,bsh,bshp->bthp", cb * m, dtc, xc)
        y = y + torch.exp(lcum)[..., None] * torch.einsum(
            "bthn,bhnp->bthp", ch, state)
        w = torch.exp(lcum[:, -1:, :] - lcum) * dtc    # [Bt,q,H]
        upd = torch.einsum("bthn,bthp->bhnp", bh, xc * w[..., None])
        state = state * torch.exp(lcum[:, -1])[:, :, None, None] + upd
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bt, s, h, p)
    y = y + xf.reshape(bt, s, h, p) * D[None, None, :, None]
    return y.to(x.dtype), state


def ssm_block(cfg: ModelConfig, p, x: torch.Tensor,
              return_state: bool = False):
    """Full-sequence Mamba2 mixer. x: [B, S, d] -> [B, S, d]; with
    ``return_state`` also (the conv input's last conv-1 positions
    [B, conv-1, conv_ch], final SSD state [B, H, N, P] f32).  A prompt
    shorter than conv-1 gets its tail left-padded with the conv's zeros, so
    decode always finds a full window (the reference returns a short
    tail, which its decode step cannot take)."""
    b, s, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    zxbcdt = x @ p["w_in"]
    z, xbc_pre, dt = _split(cfg, zxbcdt)
    xbc = F.silu(causal_conv(xbc_pre, p["conv_w"], p["conv_b"]))
    di = cfg.d_inner
    xs = xbc[..., :di].reshape(b, s, h, pd)
    Bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    Cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"].float())
    D = p["d_skip"].float()
    if cfg.attn_impl in ("pallas", "ref"):
        y, state = ssd_ops.ssd(xs.contiguous(), dt, A, Bm.contiguous(),
                               Cm.contiguous(), D, chunk=cfg.ssd_chunk,
                               use_kernel=False if cfg.attn_impl == "ref"
                               else None)
    else:
        y, state = _ssd_chunk_scan(cfg, xs, dt, A, Bm, Cm, D)
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_w"], cfg.rms_eps)
    out = y @ p["w_out"]
    if return_state:
        k1 = cfg.ssm_conv - 1
        tail = xbc_pre[:, max(s - k1, 0):]
        return out, (F.pad(tail, (0, 0, k1 - tail.shape[1], 0)), state)
    return out


def ssm_decode_step(cfg: ModelConfig, p, x: torch.Tensor,
                    conv_state: torch.Tensor, ssd_state: torch.Tensor):
    """One-token recurrent step, plain torch on every device.

    x: [B, 1, d]; conv_state: [B, conv-1, conv_ch]; ssd_state: [B,H,N,P].
    Returns (out [B, 1, d], conv_state, ssd_state) -- new tensors; the
    caller decides which rows keep them."""
    b = x.shape[0]
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    z, xbc, dt = _split(cfg, x @ p["w_in"])
    # conv over the stored window + new input
    win = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)   # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", win.float(),
                            p["conv_w"].float()) + p["conv_b"]
    xbc_t = F.silu(conv_out)
    conv_state = win[:, 1:, :]
    di = cfg.d_inner
    xs = xbc_t[:, :di].reshape(b, h, pd)
    Bm = xbc_t[:, di:di + g * n].reshape(b, g, n)
    Cm = xbc_t[:, di + g * n:].reshape(b, g, n)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["a_log"].float())
    y, ssd_state = ssd_ops.ssd_decode_step(xs, dtv, A, Bm, Cm,
                                           p["d_skip"].float(), ssd_state)
    y = y.reshape(b, 1, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_w"], cfg.rms_eps)
    # y is f32 here: the reference's f32 @ bf16 promotes the weight
    out = (y @ p["w_out"].to(y.dtype)).to(x.dtype)
    return out, conv_state.to(x.dtype), ssd_state
