"""QuadConv autoencoder for flow-state compression (paper §4, Fig. 9).

Port of ``src/repro/ml/autoencoder.py``: the encoder (and decoder) as
plain functions over a params dict with the reference's layout, so the
reference's weights carry across with :func:`params_from_numpy`.

  encoder:  ``blocks`` × [QuadConv → GELU → LayerNorm → ``pool``× point
            max-pool], then flatten → linear → latent
  decoder:  linear → unflatten → ``blocks`` × [unpool → QuadConv → GELU →
            LayerNorm] → linear channel head

LayerNorm uses the population variance (``jnp.var``'s default); GELU is
the tanh approximation.  ``loss_fn`` (MSE) and ``rel_frobenius`` (paper
Eq. 1) are the trainer's metrics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .quadconv import QuadConv

__all__ = ["AEConfig", "init_autoencoder", "params_from_numpy", "encode",
           "decode", "reconstruct", "loss_fn", "rel_frobenius",
           "compression_factor", "coords_pyramid"]


@dataclass(frozen=True)
class AEConfig:
    n_points: int               # level-0 point count (per rank partition)
    channels: int = 4           # (p, u, v, w)
    internal: int = 16          # paper: 16 internal data channels
    latent: int = 100           # paper: latent dimension 100
    blocks: int = 2             # paper: two blocks in encoder and decoder
    pool: int = 4               # point-pool factor per block
    mlp_width: int = 32
    mlp_depth: int = 5          # paper: five-layer filter MLPs
    support: float = 0.75
    mode: str | None = None     # quadconv contraction: None=kernel | "ref"

    def level_points(self, level: int) -> int:
        return self.n_points // (self.pool ** level)

    @property
    def bottleneck(self) -> int:
        return self.level_points(self.blocks) * self.internal


def compression_factor(cfg: AEConfig) -> float:
    """Paper: size of the per-rank simulation data / latent dimension."""
    return (cfg.n_points * cfg.channels) / cfg.latent


def coords_pyramid(cfg: AEConfig, coords: torch.Tensor) -> list[torch.Tensor]:
    """Strided point subsets per level: [N], [N/4], [N/16], ..."""
    out = [coords]
    for level in range(1, cfg.blocks + 1):
        out.append(coords[:: cfg.pool ** level].contiguous())
    return out


def _conv(cfg: AEConfig, c_in: int, c_out: int) -> QuadConv:
    return QuadConv(c_in=c_in, c_out=c_out, mlp_width=cfg.mlp_width,
                    mlp_depth=cfg.mlp_depth, support=cfg.support,
                    mode=cfg.mode)


def _linear(generator, din: int, dout: int, device) -> dict:
    w = torch.randn((din, dout), generator=generator) * (1.0 / din) ** 0.5
    return {"w": w.to(device), "b": torch.zeros((dout,), device=device)}


def init_autoencoder(cfg: AEConfig, generator: torch.Generator,
                     device=None) -> dict:
    """Random weights in the reference's layout, drawn on the CPU from
    ``generator`` and placed on ``device`` (default: the card)."""
    dev = resolve_device(device)
    params: dict[str, Any] = {"enc": [], "dec": []}
    c = cfg.channels
    for b in range(cfg.blocks):
        p = _conv(cfg, c, cfg.internal).init(generator, cfg.level_points(b),
                                             dev)
        p["ln_scale"] = torch.ones((cfg.internal,), device=dev)
        p["ln_bias"] = torch.zeros((cfg.internal,), device=dev)
        params["enc"].append(p)
        c = cfg.internal
    params["enc_head"] = _linear(generator, cfg.bottleneck, cfg.latent, dev)
    params["dec_head"] = _linear(generator, cfg.latent, cfg.bottleneck, dev)
    for b in range(cfg.blocks):
        p = _conv(cfg, cfg.internal, cfg.internal).init(
            generator, cfg.level_points(cfg.blocks - b - 1), dev)
        p["ln_scale"] = torch.ones((cfg.internal,), device=dev)
        p["ln_bias"] = torch.zeros((cfg.internal,), device=dev)
        params["dec"].append(p)
    params["out_head"] = _linear(generator, cfg.internal, cfg.channels, dev)
    return params


def params_from_numpy(tree: Any, device=None) -> Any:
    """Map the reference's params pytree, converted to numpy (``enc[b]``:
    ``quad_w``, ``mlp[k].{w,b}``, ``bias``, ``ln_scale``, ``ln_bias``;
    ``enc_head``, ``dec_head``, ``dec[b]``, ``out_head``), onto the port's
    params.  The layouts are the same — MLP and head weights stay
    ``[din, dout]`` and are applied as ``x @ w`` — so nothing is
    transposed."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    return torch.as_tensor(np.array(tree), device=dev)


def _layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _pool_max(x: torch.Tensor, k: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n // k, k, c).amax(dim=2)


def _unpool(x: torch.Tensor, k: int) -> torch.Tensor:
    b, n, c = x.shape
    return x[:, :, None, :].expand(b, n, k, c).reshape(b, n * k, c)


def encode(params: dict, cfg: AEConfig, levels: list[torch.Tensor],
           f: torch.Tensor) -> torch.Tensor:
    """f: [B, N, C] → z: [B, latent]."""
    x = f
    c = cfg.channels
    for b in range(cfg.blocks):
        p = params["enc"][b]
        x = _conv(cfg, c, cfg.internal).apply(p, x, levels[b], levels[b])
        x = F.gelu(x, approximate="tanh")
        x = _layernorm(x, p["ln_scale"], p["ln_bias"])
        x = _pool_max(x, cfg.pool)
        c = cfg.internal
    x = x.reshape(x.shape[0], -1)
    return x @ params["enc_head"]["w"] + params["enc_head"]["b"]


def decode(params: dict, cfg: AEConfig, levels: list[torch.Tensor],
           z: torch.Tensor) -> torch.Tensor:
    """z: [B, latent] → f̂: [B, N, C]."""
    x = z @ params["dec_head"]["w"] + params["dec_head"]["b"]
    x = x.reshape(z.shape[0], cfg.level_points(cfg.blocks), cfg.internal)
    for b in range(cfg.blocks):
        lvl = cfg.blocks - b - 1
        x = _unpool(x, cfg.pool)
        p = params["dec"][b]
        x = _conv(cfg, cfg.internal, cfg.internal).apply(
            p, x, levels[lvl], levels[lvl])
        x = F.gelu(x, approximate="tanh")
        x = _layernorm(x, p["ln_scale"], p["ln_bias"])
    return x @ params["out_head"]["w"] + params["out_head"]["b"]


def reconstruct(params: dict, cfg: AEConfig, levels: list[torch.Tensor],
                f: torch.Tensor) -> torch.Tensor:
    return decode(params, cfg, levels, encode(params, cfg, levels, f))


def loss_fn(params: dict, cfg: AEConfig, levels: list[torch.Tensor],
            f: torch.Tensor) -> torch.Tensor:
    """Mean-squared reconstruction error (paper: MSE loss)."""
    rec = reconstruct(params, cfg, levels, f)
    return torch.mean(torch.square(rec - f))


def rel_frobenius(f: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 1: mean over samples of ‖F−F̂‖_F / ‖F‖_F."""
    num = torch.sqrt(torch.sum(torch.square(f - rec), dim=(-2, -1)))
    den = torch.sqrt(torch.sum(torch.square(f), dim=(-2, -1)))
    return torch.mean(num / torch.clamp(den, min=1e-12))
