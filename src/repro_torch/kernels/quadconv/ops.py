"""Public entry point for the QuadConv contraction.

Port of ``src/repro/kernels/quadconv/ops.py``:

    quadconv_contract(f, w, g, mode=None)
        out[b, j, o] = Σ_{i,c} w[i] · G[j, i, o, c] · f[b, i, c]

``mode=None`` dispatches on the device of ``f``: CPU tensors take the plain
einsum (``ref.py``), CUDA tensors launch the hand-written kernel in
``csrc/quadconv.cu`` or raise — there is no fallback.  ``mode="ref"`` asks
for the plain einsum on any device (the reference the kernel is held to on
the card, as the JAX package's ``mode="ref"``).  The kernel reads ``g`` in
its native ``[J, I, O, C]`` layout, so no transpose or padding happens
here.

The contraction is a ``torch.autograd.Function``.  Its backward is the
reference's own VJP (``_bwd``, three einsums — not a Pallas kernel there
either), with the shared intermediate ``t[b,i,c] = Σ_{j,o} G[j,i,o,c]
ct[b,j,o]`` computed once:

    df[b,i,c]   = w[i] · t[b,i,c]
    dw[i]       = Σ_{b,c} f[b,i,c] · t[b,i,c]
    dG[j,i,o,c] = Σ_b ct[b,j,o] · w[i] · f[b,i,c]

Both big contractions are torch products; ``t`` reads G once through a
transposed copy that ``torch.einsum`` makes (G's size, freed on return).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import quadconv_contract_ref

__all__ = ["quadconv_contract", "QUADCONV"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = _build.Library("quadconv",
                      Path(__file__).parent / "csrc" / "quadconv.cu")
#: ``kernel.py::quadconv_matmul`` on Hopper (see ``csrc/quadconv.cu``).
QUADCONV = _build.Kernel(_LIB, "quadconv_contract",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])


def _check(f, w, g) -> None:
    b, i, c = f.shape
    j, i2, o, c2 = g.shape
    if (i, c) != (i2, c2) or w.shape != (i,):
        raise ValueError(f"quadconv_contract: f {tuple(f.shape)}, "
                         f"w {tuple(w.shape)}, g {tuple(g.shape)}")
    oc = o * c
    if c % 4 or c > 128 or oc < 4 or oc > 1024 or oc & (oc - 1):
        raise ValueError(f"quadconv kernel takes C % 4 == 0, C <= 128 and "
                         f"O*C a power of two in [4, 1024]; got O={o}, C={c}")
    for name, t in (("f", f), ("w", w), ("g", g)):
        if t.device != f.device:
            raise ValueError(f"quadconv_contract: {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"quadconv kernel takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"quadconv kernel: {name} must be contiguous "
                             "and 16-byte aligned")


def quadconv_contract(f: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      mode: str | None = None) -> torch.Tensor:
    """out[b,j,o] = Σ_{i,c} w[i] G[j,i,o,c] f[b,i,c].  See module docstring."""
    if mode not in (None, "ref"):
        raise ValueError(f"unknown quadconv mode {mode!r} (None or 'ref')")
    return _Contract.apply(f, w, g, mode)


class _Contract(torch.autograd.Function):
    """The contraction with the reference's einsum VJP."""

    @staticmethod
    def forward(ctx, f, w, g, mode):
        ctx.save_for_backward(f, w, g)
        return _forward(f, w, g, mode)

    @staticmethod
    def backward(ctx, ct):
        f, w, g = ctx.saved_tensors
        need_f, need_w, need_g = ctx.needs_input_grad[:3]
        df = dw = dg = None
        if need_f or need_w:
            t = torch.einsum("jioc,bjo->bic", g, ct)
            if need_f:
                df = t * w[None, :, None]
            if need_w:
                dw = torch.einsum("bic,bic->i", f, t)
        if need_g:
            dg = torch.einsum("bjo,bic->jioc", ct, f * w[None, :, None])
        return df, dw, dg, None


def _forward(f, w, g, mode):
    if mode == "ref" or f.device.type == "cpu":
        return quadconv_contract_ref(f, w, g)
    if f.device.type != "cuda":
        raise ValueError(f"quadconv_contract: no kernel for {f.device}")
    _check(f, w, g)
    b, i, _ = f.shape
    j, _, o, c = g.shape
    out = torch.empty((b, j, o), dtype=torch.float32, device=f.device)
    if b and j:
        QUADCONV.launch(f.data_ptr(), w.data_ptr(), g.data_ptr(),
                        out.data_ptr(), b, i, j, o, c,
                        _P(torch.cuda.current_stream(f.device).cuda_stream))
    return out
