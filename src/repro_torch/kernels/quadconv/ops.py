"""Public entry point for the QuadConv contraction.

Port of ``src/repro/kernels/quadconv/ops.py``, forward only:

    quadconv_contract(f, w, g, mode=None)
        out[b, j, o] = Σ_{i,c} w[i] · G[j, i, o, c] · f[b, i, c]

``mode=None`` dispatches on the device of ``f``: CPU tensors take the plain
einsum (``ref.py``), CUDA tensors launch the hand-written kernel in
``csrc/quadconv.cu`` or raise — there is no fallback.  ``mode="ref"`` asks
for the plain einsum on any device (the reference the kernel is held to on
the card, as the JAX package's ``mode="ref"``).  The kernel reads ``g`` in
its native ``[J, I, O, C]`` layout, so no transpose or padding happens
here.  The backward (three einsums in the reference) comes with the
training slice as a ``torch.autograd.Function`` (``ROADMAP.md`` A2).
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
    if mode == "ref" or (mode is None and f.device.type == "cpu"):
        return quadconv_contract_ref(f, w, g)
    if mode is not None:
        raise ValueError(f"unknown quadconv mode {mode!r} (None or 'ref')")
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
