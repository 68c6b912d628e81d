"""Public entry: the full chunked SSD scan with the intra-chunk kernel.

Port of ``src/repro/kernels/ssd/ops.py`` and ``kernel.py``:

* ``ssd_intra(xdt, a, b, c)`` — the intra-chunk step
  (``kernel.py::ssd_intra``): a CPU tensor takes the plain version
  (``ref.ssd_intra_ref``), a CUDA tensor launches ``csrc/ssd.cu`` (its
  scores, y and state kernels, on the tensor cores with operands split
  into two bf16 terms) or raises.  The kernel takes fp32 only, as the reference
  computes.
* ``ssd_scan(xdt, a, b_coef, c_coef, chunk, mode, h0)`` — reproduces
  ``models.ssd.ssd_scan_chunked`` (note its argument order: ``b`` before
  ``c`` here, ``c`` before ``b`` there), with the O(S/chunk) inter-chunk
  recurrence as a Python loop.  ``mode=None`` (or ``"interpret"``, the
  reference's CPU-test mode, accepted as its alias) dispatches on the
  device through ``ssd_intra``; ``mode="ref"`` takes the plain version on
  any device.  ``S`` must be a multiple of ``min(chunk, S)``.

The kernel is forward only: a CUDA call that needs a gradient raises
(the CPU's plain version differentiates by autograd).  Mamba-2 trains
through the chunked scan, ``ssd_impl="xla"``, the reference's default.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import ssd_intra_ref

__all__ = ["ssd_scan", "ssd_intra", "SSD_INTRA"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = _build.Library("ssd", Path(__file__).parent / "csrc" / "ssd.cu")
#: ``kernel.py::ssd_intra`` on Hopper (see ``csrc/ssd.cu``).
SSD_INTRA = _build.Kernel(_LIB, "ssd_intra", [_P] * 8 + [_I] * 5 + [_P])


def _launch(xdt, a, b, c):
    BC, Q, H, P = xdt.shape
    N = b.shape[-1]
    if a.shape != (BC, Q, H) or b.shape != (BC, Q, N) or c.shape != b.shape:
        raise ValueError(f"ssd_intra: xdt {tuple(xdt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}")
    for name, t in (("xdt", xdt), ("a", a), ("b", b), ("c", c)):
        if t.device != xdt.device:
            raise ValueError(f"ssd_intra: {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd kernel: {name} must be contiguous")
    if P % 4 or P > 64 or Q > 4096:
        raise ValueError(f"ssd kernel takes P a multiple of 4, <= 64 and "
                         f"Q <= 4096; got P={P}, Q={Q}")
    dev = xdt.device
    y = torch.empty((BC, Q, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((BC, H, P, N), dtype=torch.float32, device=dev)
    cum = torch.empty((BC, Q, H), dtype=torch.float32, device=dev)
    if BC and Q and H:
        # scratch: each chunk's causal 64 x 64 score tiles, built once and
        # shared by every head
        tiles = -(-Q // 64)
        scores = torch.empty(BC * tiles * (tiles + 1) // 2 * 64 * 64,
                             dtype=torch.float32, device=dev)
        SSD_INTRA.launch(xdt.data_ptr(), a.data_ptr(), b.data_ptr(),
                         c.data_ptr(), y.data_ptr(), state.data_ptr(),
                         cum.data_ptr(), scores.data_ptr(), BC, Q, H, P, N,
                         _P(torch.cuda.current_stream(dev).cuda_stream))
    return y, state, cum


def ssd_intra(xdt, a, b, c):
    """xdt:[BC,Q,H,P], a:[BC,Q,H], b,c:[BC,Q,N] →
    (y [BC,Q,H,P] f32, state [BC,H,P,N] f32, cum [BC,Q,H] f32)."""
    if xdt.device.type == "cpu":
        return ssd_intra_ref(xdt, a, b, c)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_intra: no kernel for {xdt.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xdt, a, b, c)):
        raise NotImplementedError(
            "ssd_intra has no backward kernel (nor has the reference's "
            "Pallas kernel): train Mamba-2 with ssd_impl='xla'")
    return _launch(xdt, a, b, c)


def ssd_scan(xdt, a, b_coef, c_coef, chunk: int, mode: str | None = None,
             h0=None):
    """Same contract as models.ssd.ssd_scan_chunked: returns (y, h_final)."""
    if mode not in (None, "interpret", "ref"):
        raise ValueError(f"unknown ssd mode {mode!r}")
    B, S, H, P = xdt.shape
    N = b_coef.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"S={S} must divide chunk={Q} (pad upstream)")
    nc = S // Q
    xdt_c = xdt.float().reshape(B * nc, Q, H, P).contiguous()
    a_c = a.float().reshape(B * nc, Q, H).contiguous()
    b_c = b_coef.float().reshape(B * nc, Q, N).contiguous()
    c_c = c_coef.float().reshape(B * nc, Q, N).contiguous()
    intra = ssd_intra_ref if mode == "ref" else ssd_intra
    y_i, states, cum = intra(xdt_c, a_c, b_c, c_c)

    y_i = y_i.reshape(B, nc, Q, H, P)
    states = states.reshape(B, nc, H, P, N)
    cum = cum.reshape(B, nc, Q, H)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # [B,nc,H]

    # inter-chunk recurrence: h_c = decay_c · h_{c-1} + S_c (a short loop)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device) \
        if h0 is None else h0.float()
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, ci, :, None, None] * h + states[:, ci]
    h_prevs = torch.stack(h_prevs, dim=1)                  # [B,nc,H,P,N]

    # inter-chunk contribution: y_i += exp(cum) · C_i · h_prev
    y_x = torch.einsum("bcqn,bchpn,bcqh->bcqhp",
                       c_c.reshape(B, nc, Q, N), h_prevs, torch.exp(cum))
    return (y_i + y_x).reshape(B, S, H, P), h
