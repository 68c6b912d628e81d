"""Plain PyTorch version of the QuadConv quadrature contraction.

Port of ``src/repro/kernels/quadconv/ref.py``:

    out[b, j, o] = Σ_i Σ_c  w[i] · G[j, i, o, c] · f[b, i, c]

one einsum.  Full fp32 on the card needs TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, the default).
"""

from __future__ import annotations

import torch

__all__ = ["quadconv_contract_ref"]


def quadconv_contract_ref(f: torch.Tensor, w: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """f [B, I, C], w [I], g [J, I, O, C] → [B, J, O]."""
    return torch.einsum("i,jioc,bic->bjo", w, g, f)
