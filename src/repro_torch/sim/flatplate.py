"""Synthetic turbulent flat-plate boundary-layer snapshots (paper §4 data).

Port of ``src/repro/sim/flatplate.py``: a composite law-of-the-wall mean
profile plus divergence-suppressed random Fourier-mode fluctuations on a
wall-stretched non-uniform grid, convected in ``step`` (frozen
turbulence).

The reference draws its modes inside ``snapshot`` with ``jax.random``.
The port splits that in two: :func:`draw_modes` draws ``(kvec, phase0,
raw)`` with a ``torch.Generator``, and :func:`snapshot` evaluates a
snapshot from given modes — so a test can feed the reference's own draws
and compare the snapshots.  :func:`snapshot_batch` evaluates consecutive
steps in one batched pass, as the reference's ``vmap`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..device import resolve_device

__all__ = ["FlatPlateConfig", "Modes", "grid_coords", "draw_modes",
           "snapshot", "snapshot_batch"]

KAPPA = 0.41
B_LOG = 5.2


@dataclass(frozen=True)
class FlatPlateConfig:
    nx: int = 16
    ny: int = 16                # wall-normal (stretched)
    nz: int = 8
    n_modes: int = 32           # random Fourier modes
    re_tau: float = 400.0       # friction Reynolds number
    stretch: float = 2.5        # wall-normal geometric stretching strength
    lx: float = 6.0
    lz: float = 3.0
    u_conv: float = 0.5         # frozen-turbulence convection speed

    @property
    def n_points(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def channels(self) -> int:
        return 4                 # (p, u, v, w)


@dataclass(frozen=True)
class Modes:
    """One snapshot family's random modes (float32 tensors)."""

    kvec: torch.Tensor      # [M, 3] wavevectors
    phase0: torch.Tensor    # [M] initial phases in [0, 2π)
    raw: torch.Tensor       # [M, 3] unnormalized polarizations

    def to(self, device) -> "Modes":
        return Modes(self.kvec.to(device), self.phase0.to(device),
                     self.raw.to(device))


def grid_coords(cfg: FlatPlateConfig, device=None) -> torch.Tensor:
    """Non-uniform grid coordinates, shape [n_points, 3] (x, y, z); y uses
    tanh clustering toward the wall (y=0)."""
    dev = resolve_device(device)
    x = torch.arange(cfg.nx, dtype=torch.float32, device=dev) \
        * (cfg.lx / cfg.nx)
    eta = torch.linspace(0.0, 1.0, cfg.ny, device=dev)
    y = 1.0 - torch.tanh(cfg.stretch * (1.0 - eta)) / math.tanh(cfg.stretch)
    z = torch.arange(cfg.nz, dtype=torch.float32, device=dev) \
        * (cfg.lz / cfg.nz)
    X, Y, Z = torch.meshgrid(x, y, z, indexing="ij")
    return torch.stack([X.ravel(), Y.ravel(), Z.ravel()], dim=-1)


def draw_modes(cfg: FlatPlateConfig, generator: torch.Generator,
               device=None) -> Modes:
    """Draw the random modes (the reference's ``jax.random`` draws, with the
    same distributions) on the CPU from ``generator``."""
    m = cfg.n_modes
    kvec = torch.randn((m, 3), generator=generator) \
        * torch.tensor([4.0, 8.0, 4.0])
    phase0 = torch.rand((m,), generator=generator) * (2 * math.pi)
    raw = torch.randn((m, 3), generator=generator)
    return Modes(kvec, phase0, raw).to(resolve_device(device))


def _mean_profile(cfg: FlatPlateConfig, y: torch.Tensor) -> torch.Tensor:
    """Composite law-of-the-wall mean streamwise velocity (in u_τ units)."""
    yplus = torch.clamp(y * cfg.re_tau, min=1e-6)
    visc = yplus
    log = torch.log(yplus) / KAPPA + B_LOG
    blend = 1.0 - torch.exp(-yplus / 11.0)
    return (1 - blend) * visc + blend * torch.minimum(log, visc + 20.0)


def _intensity(y: torch.Tensor, re_tau: float) -> torch.Tensor:
    """Wall-damped turbulence intensity, peaking near y⁺ ≈ 15."""
    yplus = torch.clamp(y * re_tau, min=0.0)
    return (yplus / 15.0) * torch.exp(1.0 - yplus / 15.0) * 2.0 \
        + 0.1 * torch.exp(-y)


def snapshot(cfg: FlatPlateConfig, modes: Modes, step,
             coords: torch.Tensor | None = None) -> torch.Tensor:
    """One (p,u,v,w) snapshot, shape [4, n_points], on the device of the
    modes (``coords`` defaults to :func:`grid_coords` there)."""
    return _evaluate(cfg, modes, [step], coords)[0]


def snapshot_batch(cfg: FlatPlateConfig, modes: Modes, step0, n: int,
                   coords: torch.Tensor | None = None) -> torch.Tensor:
    """``n`` consecutive steps from ``step0``, shape [n, 4, n_points], in
    one batched evaluation: each row is :func:`snapshot` of its step, by
    the same arithmetic (bit for bit on the CPU)."""
    return _evaluate(cfg, modes, [step0 + i for i in range(n)], coords)


def _evaluate(cfg: FlatPlateConfig, modes: Modes, steps: list,
              coords: torch.Tensor | None) -> torch.Tensor:
    """The snapshots of ``steps`` → [len(steps), 4, n_points]."""
    dev = modes.kvec.device
    if coords is None:
        coords = grid_coords(cfg, dev)
    y = coords[:, 1]
    kvec = modes.kvec
    kmag = torch.linalg.norm(kvec, dim=-1) + 1e-3
    # Kolmogorov-ish amplitude decay |k|^{-5/6} per component
    amp = kmag ** (-5.0 / 6.0)
    amp = amp / torch.sqrt(torch.sum(amp ** 2))
    # random unit polarization ⊥ k (suppresses divergence mode-by-mode)
    raw = modes.raw
    pol = raw - kvec * torch.sum(raw * kvec, -1, keepdim=True) \
        / (kmag[:, None] ** 2)
    pol = pol / (torch.linalg.norm(pol, dim=-1, keepdim=True) + 1e-8)

    # frozen turbulence: phases convect downstream with u_conv
    shift = torch.tensor([cfg.u_conv * float(t) for t in steps],
                         dtype=torch.float32, device=dev)
    phases = ((coords @ kvec.T) + modes.phase0[None, :])[None] \
        - shift[:, None, None] * kvec[None, None, :, 0]     # [S, N, M]
    waves = torch.sin(phases)
    fluct = (waves * amp).reshape(-1, amp.shape[0]) @ pol
    fluct = fluct.reshape(len(steps), -1, 3) \
        * _intensity(y, cfg.re_tau)[None, :, None]           # [S, N, 3]

    u = _mean_profile(cfg, y) + fluct[..., 0] * 2.0
    v = fluct[..., 1]
    w = fluct[..., 2]
    p_amp = amp * (kmag ** (-1.0 / 3.0))
    p = (torch.cos(phases) * p_amp).sum(-1) * _intensity(y, cfg.re_tau)
    return torch.stack([p, u, v, w], dim=1).to(torch.float32)
