"""QuadConv: quadrature-based continuous convolution (Doherty et al. 2023).

Port of ``src/repro/ml/quadconv.py``.  A continuous convolution over a
non-uniform point cloud is approximated with one quadrature sum,

    (K ∗ f)(x_j) ≈ Σ_i  w_i · K_θ(x_j − y_i) · f(y_i),

with learned quadrature weights ``w_i`` and a learned kernel ``K_θ`` (an
MLP mapping 3-D offsets to an O×C matrix) under a smooth compact-support
window.  The pairwise contraction goes to ``repro_torch.kernels.quadconv``
(the hand-written kernel on the card); the MLP that builds the kernel
tensor over J×I offsets is plain ``torch`` matrix products.

Layout kept from the reference: MLP weights are ``[din, dout]`` and applied
as ``x @ w + b`` (here one ``torch.addmm``, which also saves a buffer the
size of the kernel tensor).  GELU is the tanh approximation, as
``jax.nn.gelu``'s default.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kernels.quadconv import quadconv_contract

__all__ = ["QuadConv", "mlp_init", "mlp_apply"]


def mlp_init(generator: torch.Generator, sizes: tuple[int, ...],
             scale: float = 1.0, device=None) -> list[dict]:
    """Plain MLP params: list of {w [din, dout], b [dout]}; he-style init,
    final layer scaled by ``scale``.  Drawn on the CPU from ``generator``
    (same numbers on every device), then moved to ``device``."""
    params = []
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        std = (2.0 / din) ** 0.5
        if i == len(sizes) - 2:
            std = std * scale
        w = torch.randn((din, dout), generator=generator) * std
        params.append({"w": w.to(device),
                       "b": torch.zeros((dout,), device=device)})
    return params


def mlp_apply(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = torch.addmm(layer["b"], x, layer["w"])
        if i < len(params) - 1:
            x = F.gelu(x, approximate="tanh")
    return x


def _bump(d2: torch.Tensor, r: float) -> torch.Tensor:
    """C¹ compact-support window: (max(0, 1 − (d/r)²))²."""
    return torch.clamp(1.0 - d2 / (r * r), min=0.0).square()


@dataclass(frozen=True)
class QuadConv:
    """One QuadConv layer: I input points/C channels → J output points/O.

    Static hyper-parameters only; learned state lives in a params dict.
    ``mode``: ``None`` runs the contraction kernel on CUDA tensors (the
    plain einsum on CPU tensors); ``"ref"`` asks for the plain einsum on
    any device.
    """

    c_in: int
    c_out: int
    mlp_width: int = 32
    mlp_depth: int = 5          # paper: five-layer filter MLPs
    support: float = 0.75       # compact-support radius (domain units)
    mode: str | None = None

    def init(self, generator: torch.Generator, n_in_points: int,
             device=None) -> dict:
        sizes = (3,) + (self.mlp_width,) * (self.mlp_depth - 1) \
            + (self.c_out * self.c_in,)
        return {
            # learned quadrature weights, init to uniform rule 1/I
            "quad_w": torch.full((n_in_points,), 1.0 / n_in_points,
                                 device=device),
            "mlp": mlp_init(generator, sizes, scale=0.3, device=device),
            "bias": torch.zeros((self.c_out,), device=device),
        }

    def kernel_tensor(self, params: dict, coords_out: torch.Tensor,
                      coords_in: torch.Tensor) -> torch.Tensor:
        """G[j,i,o,c] = MLP(x_j − y_i) ⊙ bump(|x_j − y_i|), contiguous."""
        deltas = coords_out[:, None, :] - coords_in[None, :, :]   # [J,I,3]
        j, i, _ = deltas.shape
        g = mlp_apply(params["mlp"], deltas.reshape(j * i, 3))
        g = g.reshape(j, i, self.c_out, self.c_in)
        win = _bump((deltas * deltas).sum(-1), self.support)     # [J,I]
        # In place: g is a fresh addmm output that addmm's backward does
        # not keep, and win carries no gradient (the coordinates are
        # constants), so mul_'s backward needs win alone.  A gradient
        # through win would need the pre-multiply g, which this overwrites.
        return g.mul_(win[:, :, None, None])

    def apply(self, params: dict, f: torch.Tensor, coords_in: torch.Tensor,
              coords_out: torch.Tensor) -> torch.Tensor:
        """f: [B, I, C_in] → [B, J, C_out]."""
        g = self.kernel_tensor(params, coords_out, coords_in)
        out = quadconv_contract(f.contiguous(), params["quad_w"], g,
                                self.mode)
        return out + params["bias"]
