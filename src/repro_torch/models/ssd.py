"""Mamba-2 / SSD mixer (state-space duality, arXiv:2405.21060).

Port of ``src/repro/models/ssd.py``.  The selective state-space
recurrence with scalar per-head decay,

    h_t = exp(Δt·A) · h_{t-1} + (Δt·x_t) ⊗ B_t ,   y_t = C_t·h_t + D·x_t,

evaluated with the paper's chunked (matmul) algorithm: within a chunk of
Q steps the contribution is a masked "attention-like" product
``(C Bᵀ ∘ L) X``, and chunk states are carried by a short sequential loop
— equal to the recurrence (``ssd_scan_ref``) up to fp32 rounding.

Block layout follows Mamba-2: in-proj → (z gate | x | B | C | Δt), causal
depthwise conv(4) on x/B/C, SSD core, gated RMSNorm, out-proj;
``n_groups=1`` (B/C shared across heads).  Decode keeps a conv tail and
the [H,P,N] state.

``ssd_apply`` takes the intra-chunk kernel (``kernels.ssd.ssd_scan``)
when ``cfg.ssd_impl`` is ``"kernel"`` (or its CPU alias
``"kernel_interpret"``) and ``S`` is a multiple of ``min(chunk, S)`` — the
reference's own dispatch on shape; otherwise the chunked scan here, which
pads the tail.  The causal conv is the reference's unrolled shifted sums,
not ``conv1d`` (on the card cuDNN would run a convolution in TF32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.sharding import ParamSpec
from .layers import rmsnorm

__all__ = ["MambaCache", "ssd_specs", "ssd_apply", "ssd_decode",
           "init_mamba_cache", "ssd_scan_ref", "ssd_scan_chunked"]


class MambaCache(NamedTuple):
    conv_x: torch.Tensor   # [B, k-1, di]
    conv_b: torch.Tensor   # [B, k-1, N]
    conv_c: torch.Tensor   # [B, k-1, N]
    state: torch.Tensor    # [B, H, P, N] fp32


def ssd_specs(cfg, stacked: tuple[int, ...] = ()) -> dict:
    D, di = cfg.d_model, cfg.ssm_inner
    N, H, K = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    lay = ("layers",) * len(stacked)
    return {
        "w_z": ParamSpec(stacked + (D, di), lay + ("embed", "mlp")),
        "w_x": ParamSpec(stacked + (D, di), lay + ("embed", "mlp")),
        "w_b": ParamSpec(stacked + (D, N), lay + ("embed", None)),
        "w_c": ParamSpec(stacked + (D, N), lay + ("embed", None)),
        "w_dt": ParamSpec(stacked + (D, H), lay + ("embed", "heads")),
        "conv_x": ParamSpec(stacked + (K, di), lay + (None, "mlp"),
                            "normal", 0.5),
        "conv_b": ParamSpec(stacked + (K, N), lay + (None, None),
                            "normal", 0.5),
        "conv_c": ParamSpec(stacked + (K, N), lay + (None, None),
                            "normal", 0.5),
        "a_log": ParamSpec(stacked + (H,), lay + ("heads",), "zeros"),
        "d": ParamSpec(stacked + (H,), lay + ("heads",), "ones"),
        "dt_bias": ParamSpec(stacked + (H,), lay + ("heads",), "zeros"),
        "gn_scale": ParamSpec(stacked + (di,), lay + ("mlp",), "ones"),
        "w_out": ParamSpec(stacked + (di, D), lay + ("mlp", "embed")),
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B,S,C]; w: [K,C] depthwise causal conv (pad left K-1), as the
    reference's unrolled shifted sums."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i: i + x.shape[1], :] * w[i][None, None, :]
               for i in range(K))


def _conv_step(tail: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor):
    """Decode-time conv: tail [B,K-1,C], x_new [B,1,C] → (y [B,1,C], tail')."""
    window = torch.cat([tail, x_new], dim=1)                # [B,K,C]
    y = torch.einsum("bkc,kc->bc", window, w)[:, None, :]
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_scan_ref(xdt, a, b, c, h0=None):
    """Sequential oracle.  xdt:[B,S,H,P] (Δt·x), a:[B,S,H] (Δt·A, ≤0),
    b,c:[B,S,N] → y:[B,S,H,P], h_final:[B,H,P,N]."""
    B, S, H, P = xdt.shape
    N = b.shape[-1]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device) \
        if h0 is None else h0
    ys = []
    for t in range(S):
        h = torch.exp(a[:, t])[..., None, None] * h \
            + xdt[:, t, :, :, None] * b[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t]))
    return torch.stack(ys, dim=1), h


def ssd_scan_chunked(xdt, a, c_coef, b_coef, chunk: int, h0=None):
    """Chunked (matmul-form) SSD.  Same contract as ``ssd_scan_ref`` (note
    the argument order: ``c`` before ``b``).  The inter-chunk recurrence
    is a loop over S/Q chunks carrying [B,H,P,N]."""
    xdt, a = xdt.float(), a.float()
    b, c = b_coef.float(), c_coef.float()
    B, S, H, P = xdt.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # Zero-pad the tail: xdt=0 adds nothing and a=0 (decay exp(0)=1)
        # leaves the carried state untouched, so h_final stays exact.
        pad = Q - S % Q
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    xdt = xdt.reshape(B, nc, Q, H, P)
    a = a.reshape(B, nc, Q, H)
    b = b.reshape(B, nc, Q, N)
    c = c.reshape(B, nc, Q, N)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device) \
        if h0 is None else h0.float()
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xdt.device))
    ys = []
    for ci in range(nc):
        xdt_c, a_c, b_c, c_c = xdt[:, ci], a[:, ci], b[:, ci], c[:, ci]
        cum = torch.cumsum(a_c, dim=1)                      # inclusive
        # intra-chunk: W[i,j,h] = exp(cum_i - cum_j) for i ≥ j
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # [B,Q,Q,H]
        w = torch.where(mask[None, :, :, None], torch.exp(diff), 0.0)
        scores = torch.einsum("bin,bjn->bij", c_c, b_c)     # [B,Q,Q]
        y = torch.einsum("bij,bijh,bjhp->bihp", scores, w, xdt_c)
        # inter-chunk: contribution of carried state
        y = y + torch.einsum("bin,bhpn,bih->bihp", c_c, h, torch.exp(cum))
        # state update
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)      # [B,Q,H]
        s = torch.einsum("bjhp,bjn,bjh->bhpn", xdt_c, b_c, decay_to_end)
        h = torch.exp(cum[:, -1, :])[..., None, None] * h + s
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    return y[:, :S_orig], h


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

def _projections(params, cfg, x):
    z = x @ params["w_z"]
    xs = x @ params["w_x"]
    b = x @ params["w_b"]
    c = x @ params["w_c"]
    dt_raw = x @ params["w_dt"]
    return z, xs, b, c, dt_raw


def ssd_apply(params: dict, cfg, x: torch.Tensor, return_cache: bool = False):
    """Full-sequence mamba block.  x: [B,S,D] → [B,S,D] (+cache)."""
    B, S, D = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    z, xs, b, c, dt_raw = _projections(params, cfg, x)
    xs_conv_in, b_in, c_in = xs, b, c
    xs = F.silu(_causal_conv(xs, params["conv_x"]))
    b = F.silu(_causal_conv(b, params["conv_b"]))
    c = F.silu(_causal_conv(c, params["conv_c"]))
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"].float())
    xh = xs.reshape(B, S, H, P)
    xdt = xh.float() * dt[..., None]
    a = dt * A[None, None, :]
    if cfg.ssd_impl in ("kernel", "kernel_interpret") \
            and S % min(cfg.ssm_chunk, S) == 0:
        from ..kernels.ssd import ssd_scan as _kernel_scan
        y, h = _kernel_scan(xdt, a, b, c, cfg.ssm_chunk)
    else:
        y, h = ssd_scan_chunked(xdt, a, c, b, cfg.ssm_chunk)
    y = y + params["d"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, H * P).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["gn_scale"])
    out = y @ params["w_out"]
    if not return_cache:
        return out
    K = cfg.ssm_conv
    cache = MambaCache(
        conv_x=xs_conv_in[:, S - (K - 1):, :],
        conv_b=b_in[:, S - (K - 1):, :],
        conv_c=c_in[:, S - (K - 1):, :],
        state=h,
    )
    return out, cache


def init_mamba_cache(cfg, batch: int, dtype=torch.float32,
                     device=None) -> MambaCache:
    """Zeroed conv tails and state; ``device`` defaults to the card."""
    device = resolve_device(device)
    H, P, N, K = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv
    return MambaCache(
        conv_x=torch.zeros((batch, K - 1, cfg.ssm_inner), dtype=dtype,
                           device=device),
        conv_b=torch.zeros((batch, K - 1, N), dtype=dtype, device=device),
        conv_c=torch.zeros((batch, K - 1, N), dtype=dtype, device=device),
        state=torch.zeros((batch, H, P, N), dtype=torch.float32,
                          device=device),
    )


def ssd_decode(params: dict, cfg, x: torch.Tensor, cache: MambaCache):
    """One-token decode.  x: [B,1,D] → ([B,1,D], cache')."""
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    z, xs, b, c, dt_raw = _projections(params, cfg, x)
    xs_c, tail_x = _conv_step(cache.conv_x, xs, params["conv_x"])
    b_c, tail_b = _conv_step(cache.conv_b, b, params["conv_b"])
    c_c, tail_c = _conv_step(cache.conv_c, c, params["conv_c"])
    xs_c, b_c, c_c = (F.silu(t) for t in (xs_c, b_c, c_c))
    dt = F.softplus(dt_raw.float() + params["dt_bias"])[:, 0]
    A = -torch.exp(params["a_log"].float())
    xh = xs_c.reshape(B, H, P).float()
    decay = torch.exp(dt * A[None, :])                      # [B,H]
    h = decay[..., None, None] * cache.state \
        + (dt[..., None] * xh)[..., None] * b_c[:, 0][:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, c_c[:, 0].float())
    y = y + params["d"][None, :, None] * xh
    y = y.reshape(B, 1, H * P).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["gn_scale"])
    out = y @ params["w_out"]
    return out, MambaCache(conv_x=tail_x, conv_b=tail_b, conv_c=tail_c,
                           state=h)
