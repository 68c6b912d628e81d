"""Plain PyTorch version of the SSD intra-chunk computation.

A copy of ``src/repro/kernels/ssd/ref.py``.  Per chunk (the Mamba-2
chunked algorithm's parallel part):

    cum_i   = Σ_{l≤i} a_l                          (within-chunk decay)
    Y_i     = Σ_{j≤i} (C_i·B_j) · exp(cum_i−cum_j) · xdt_j   (intra output)
    S       = Σ_j  xdt_j ⊗ B_j · exp(cum_last−cum_j)          (chunk state)

The mask is applied with ``torch.where`` after the exp, as the reference
does: the overflowing entries above the diagonal are selected away, never
multiplied.  The inter-chunk recurrence stays outside (``ops.py``).
"""

from __future__ import annotations

import torch

__all__ = ["ssd_intra_ref"]


def ssd_intra_ref(xdt, a, b, c):
    """xdt:[BC,Q,H,P] (B·chunks folded), a:[BC,Q,H], b,c:[BC,Q,N]
    → (y:[BC,Q,H,P], state:[BC,H,P,N], cum:[BC,Q,H]), all fp32."""
    xdt, a, b, c = (t.float() for t in (xdt, a, b, c))
    Q = xdt.shape[1]
    cum = torch.cumsum(a, dim=1)
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    w = torch.where(mask[None, :, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bin,bjn->bij", c, b)
    y = torch.einsum("bij,bijh,bjhp->bihp", scores, w, xdt)
    decay_end = torch.exp(cum[:, -1:, :] - cum)
    state = torch.einsum("bjhp,bjn,bjh->bhpn", xdt, b, decay_end)
    return y, state, cum
