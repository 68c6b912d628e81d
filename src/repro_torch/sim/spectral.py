"""Pseudo-spectral incompressible Navier-Stokes solver (the PHASTA analogue).

Port of ``src/repro/sim/spectral.py`` on ``torch.fft`` (cuFFT on the
card, pocketfft on the CPU).  The paper's data producer is PHASTA, a
stabilized finite-element DNS code; the stand-in is a classic
pseudo-spectral solver on a triply periodic box (Rogallo 1981), which
produces the data the paper streams: instantaneous pressure and the
three velocity components.

Numerics, as the reference's:

* Fourier collocation on an ``n³`` grid (``rfftn`` storage
  ``[3, n, n, n//2+1]``, complex64).
* Rotational form nonlinear term ``u × ω`` evaluated pseudo-spectrally
  with 2/3-rule dealiasing; the gradient part is absorbed by the
  projection.
* Helmholtz (Leray) projection enforces ``∇·u = 0`` to round-off.
* Explicit RK4 in time, viscous term explicit.  RK4 is stable while
  ``ν·k²_max·dt`` stays under ~2.78 (``k²_max = 3·(n/2)²``), so a large
  grid needs a smaller ``ν·dt`` than the 16³ settings.
* Optional negative-viscosity band forcing at ``|k| ∈ [kf_lo, kf_hi]``.
* Pressure recovered spectrally from ``∇²p = -∂ᵢ∂ⱼ(uᵢuⱼ)`` when a
  snapshot is taken (gauge ``p̂(0) = 0``).

Where it differs from the reference, on purpose:

* Every function runs on the device of the tensors it is given; the
  initial conditions take a ``device``.
* The Taylor-Green starts are evaluated and transformed in float64 and
  rounded once to complex64 (:func:`_from_field`); the solver itself is
  float32 throughout, as the reference's.
* Dividing a complex field by a real one divides each part once
  (:func:`_div_real`), as XLA does.
* :func:`random_turbulence` takes its complex noise as an input (JAX's
  threefry draw cannot be reproduced in torch): :func:`draw_noise` draws
  it from a ``torch.Generator``, and a parity test passes the
  reference's own draw.
* :func:`step` returns a new state and leaves its input as it was (the
  reference donates its input's buffers; nothing here reads a state after
  stepping it, and a stacked multi-rank carry is sliced into views).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import resolve_device

__all__ = ["NSConfig", "NSState", "taylor_green", "taylor_green_2d",
           "random_turbulence", "draw_noise", "step", "snapshot", "energy",
           "enstrophy", "max_divergence", "partition_snapshot"]

_DIMS = (-3, -2, -1)


@dataclass(frozen=True)
class NSConfig:
    n: int = 32                 # grid points per dimension
    nu: float = 1.0 / 100.0     # kinematic viscosity
    dt: float = 5e-3
    forcing: bool = False
    f_amp: float = 0.08         # negative-viscosity forcing gain
    kf_lo: float = 0.5
    kf_hi: float = 2.5
    precision: str = "float32"

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.n, self.n, self.n)

    @property
    def n_points(self) -> int:
        return self.n ** 3


class NSState(NamedTuple):
    uhat: torch.Tensor   # complex64 [3, n, n, n//2+1], divergence-free
    t: torch.Tensor      # float32 scalar time
    step: torch.Tensor   # int32 scalar step counter


# ---------------------------------------------------------------------------
# Spectral machinery
# ---------------------------------------------------------------------------

def _wavenumbers(n: int, device):
    """``(kx, ky, kz, k²)`` broadcastable to the rfft storage, float32
    integers as ``fftfreq(n, d=1/n)`` gives them."""
    k1 = torch.fft.fftfreq(n, d=1.0 / n, device=device)
    kr = torch.fft.rfftfreq(n, d=1.0 / n, device=device)
    kx = k1[:, None, None]
    ky = k1[None, :, None]
    kz = kr[None, None, :]
    return kx, ky, kz, kx ** 2 + ky ** 2 + kz ** 2


def _dealias_mask(n: int, device) -> torch.Tensor:
    k1 = torch.fft.fftfreq(n, d=1.0 / n, device=device).abs()
    kr = torch.fft.rfftfreq(n, d=1.0 / n, device=device).abs()
    cut = (2.0 / 3.0) * (n // 2)
    return ((k1[:, None, None] <= cut) & (k1[None, :, None] <= cut)
            & (kr[None, None, :] <= cut))


def _div_real(z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``z / r`` for a real ``r``: the real and imaginary parts each
    divided once, as XLA divides.  torch's complex division multiplies by
    ``1/r`` and rounds twice, which leaves a projected field's divergence
    at ~1e-8 where the reference's is ~1e-13."""
    return torch.view_as_complex(torch.view_as_real(z) / r[..., None])


def _project(cfg: NSConfig, vhat: torch.Tensor) -> torch.Tensor:
    """Leray projection onto divergence-free fields: v - k (k·v)/k²."""
    kx, ky, kz, k2 = _wavenumbers(cfg.n, vhat.device)
    k2s = torch.where(k2 == 0, 1.0, k2)
    div = kx * vhat[0] + ky * vhat[1] + kz * vhat[2]
    return torch.stack([vhat[0] - _div_real(kx * div, k2s),
                        vhat[1] - _div_real(ky * div, k2s),
                        vhat[2] - _div_real(kz * div, k2s)])


def _curl(kx, ky, kz, uhat: torch.Tensor) -> torch.Tensor:
    """Spectral curl ``i k × û``."""
    return torch.stack([1j * (ky * uhat[2] - kz * uhat[1]),
                        1j * (kz * uhat[0] - kx * uhat[2]),
                        1j * (kx * uhat[1] - ky * uhat[0])])


def _rhs(cfg: NSConfig, uhat: torch.Tensor) -> torch.Tensor:
    """dû/dt = P[(u×ω)^·dealias] - ν k² û (+ band forcing)."""
    kx, ky, kz, k2 = _wavenumbers(cfg.n, uhat.device)
    u = torch.fft.irfftn(uhat, s=cfg.shape, dim=_DIMS)
    w = torch.fft.irfftn(_curl(kx, ky, kz, uhat), s=cfg.shape, dim=_DIMS)
    nphys = torch.stack([u[1] * w[2] - u[2] * w[1],
                         u[2] * w[0] - u[0] * w[2],
                         u[0] * w[1] - u[1] * w[0]])
    del u, w
    nhat = torch.fft.rfftn(nphys, dim=_DIMS) \
        * _dealias_mask(cfg.n, uhat.device)
    del nphys
    rhs = _project(cfg, nhat) - cfg.nu * k2 * uhat
    if cfg.forcing:
        kmag = torch.sqrt(k2)
        band = (kmag >= cfg.kf_lo) & (kmag <= cfg.kf_hi)
        rhs = rhs + cfg.f_amp * torch.where(band, uhat, 0.0)
    return rhs


def step(cfg: NSConfig, state: NSState) -> NSState:
    """One RK4 time step (divergence-free in, divergence-free out); a new
    state, ``state`` itself unchanged."""
    h = cfg.dt
    u0 = state.uhat
    k1 = _rhs(cfg, u0)
    k2 = _rhs(cfg, u0 + 0.5 * h * k1)
    k3 = _rhs(cfg, u0 + 0.5 * h * k2)
    k4 = _rhs(cfg, u0 + h * k3)
    unew = u0 + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return NSState(uhat=_project(cfg, unew), t=state.t + h,
                   step=state.step + 1)


# ---------------------------------------------------------------------------
# Initial conditions
# ---------------------------------------------------------------------------

def _grid(n: int, device):
    """The grid of ``jnp.linspace(0, 2π, n, endpoint=False)`` in float32
    (``i·(2π/n)``, the step rounded to float32 first), held in float64."""
    step_ = torch.tensor(2 * math.pi / n, dtype=torch.float32)
    x = (torch.arange(n, dtype=torch.float32) * step_).double().to(device)
    return torch.meshgrid(x, x, x, indexing="ij")


def _state(cfg: NSConfig, uhat: torch.Tensor) -> NSState:
    dev = uhat.device
    return NSState(uhat=uhat, t=torch.zeros((), device=dev),
                   step=torch.zeros((), dtype=torch.int32, device=dev))


def _from_field(cfg: NSConfig, u: torch.Tensor) -> NSState:
    """A state from a float64 velocity field on the grid: transformed in
    float64 and rounded once to complex64, so each mode of an analytic
    field comes out as its exact value rounded (the reference's float32
    transform happens to give exactly symmetric modes, which a float32
    pocketfft or cuFFT transform does not), then projected."""
    uhat = torch.fft.rfftn(u, dim=_DIMS).to(torch.complex64)
    return _state(cfg, _project(cfg, uhat))


def taylor_green(cfg: NSConfig, device=None) -> NSState:
    """Classic 3-D Taylor-Green vortex (transitions to turbulence)."""
    X, Y, Z = _grid(cfg.n, resolve_device(device))
    return _from_field(cfg, torch.stack([
        torch.cos(X) * torch.sin(Y) * torch.sin(Z),
        -torch.sin(X) * torch.cos(Y) * torch.sin(Z),
        torch.zeros_like(X)]))


def taylor_green_2d(cfg: NSConfig, device=None) -> NSState:
    """2-D TGV embedded in 3-D: an *exact* NS solution,
    u = cos(x) sin(y) e^{-2νt}, v = -sin(x) cos(y) e^{-2νt}, w = 0."""
    X, Y, _ = _grid(cfg.n, resolve_device(device))
    return _from_field(cfg, torch.stack([torch.cos(X) * torch.sin(Y),
                                         -torch.sin(X) * torch.cos(Y),
                                         torch.zeros_like(X)]))


def draw_noise(cfg: NSConfig, generator: torch.Generator,
               device=None) -> torch.Tensor:
    """The complex normal noise :func:`random_turbulence` shapes:
    ``[3, n, n, n//2+1]`` complex64 on ``device`` (default: the card),
    real and imaginary parts standard normals drawn from ``generator`` on
    the generator's own device."""
    shape = (3, cfg.n, cfg.n, cfg.n // 2 + 1)
    gdev = generator.device
    re = torch.randn(shape, generator=generator, device=gdev)
    im = torch.randn(shape, generator=generator, device=gdev)
    return torch.complex(re, im).to(resolve_device(device))


def random_turbulence(cfg: NSConfig, noise: torch.Tensor, e0: float = 0.5,
                      k_peak: float = 3.0) -> NSState:
    """Divergence-free random field with a von-Karman-ish spectrum
    E(k) ∝ k⁴ exp(-2(k/k_peak)²), normalized to kinetic energy ``e0``;
    ``noise`` (:func:`draw_noise`) is the random draw, on the device the
    state is to live on."""
    _, _, _, k2 = _wavenumbers(cfg.n, noise.device)
    kmag = torch.sqrt(k2)
    amp = (kmag ** 2) * torch.exp(-((kmag / k_peak) ** 2))
    uhat = _project(cfg, noise * amp) * _dealias_mask(cfg.n, noise.device)
    state = _state(cfg, uhat)
    scale = torch.sqrt(e0 / torch.clamp(energy(cfg, state), min=1e-30))
    return state._replace(uhat=uhat * scale)


# ---------------------------------------------------------------------------
# Diagnostics + snapshots
# ---------------------------------------------------------------------------

def _plane_weights(n: int, device) -> torch.Tensor:
    """Parseval weights of the rfft storage's kz planes: the interior
    planes stand for two modes each, kz = 0 and (even n) the Nyquist plane
    for one."""
    w = torch.ones(n // 2 + 1, device=device)
    w[1:n // 2 + (n % 2)] = 2.0
    return w


def energy(cfg: NSConfig, state: NSState) -> torch.Tensor:
    """Mean kinetic energy ½⟨|u|²⟩ via Parseval on the rfft storage."""
    n = cfg.n
    spec = torch.sum(state.uhat.abs() ** 2
                     * _plane_weights(n, state.uhat.device))
    return 0.5 * spec / (n ** 6)


def enstrophy(cfg: NSConfig, state: NSState) -> torch.Tensor:
    kx, ky, kz, _ = _wavenumbers(cfg.n, state.uhat.device)
    what = _curl(kx, ky, kz, state.uhat)
    n = cfg.n
    return 0.5 * torch.sum(what.abs() ** 2
                           * _plane_weights(n, what.device)) / (n ** 6)


def max_divergence(cfg: NSConfig, state: NSState) -> torch.Tensor:
    kx, ky, kz, _ = _wavenumbers(cfg.n, state.uhat.device)
    u = state.uhat
    div = 1j * (kx * u[0] + ky * u[1] + kz * u[2])
    return torch.fft.irfftn(div, s=cfg.shape, dim=_DIMS).abs().max()


def snapshot(cfg: NSConfig, state: NSState) -> torch.Tensor:
    """Instantaneous (p, u, v, w) on the grid, flattened to [4, n³]: what
    each PHASTA rank streams to the database every (other) time step.
    Pressure solves ``∇²p = -∂ᵢ∂ⱼ(uᵢuⱼ)`` spectrally."""
    kx, ky, kz, k2 = _wavenumbers(cfg.n, state.uhat.device)
    u = torch.fft.irfftn(state.uhat, s=cfg.shape, dim=_DIMS)
    k = (kx, ky, kz)
    acc = torch.zeros_like(state.uhat[0])
    for i in range(3):
        for j in range(3):
            uij_hat = torch.fft.rfftn(u[i] * u[j], dim=_DIMS)
            acc = acc + k[i] * k[j] * uij_hat
    k2s = torch.where(k2 == 0, 1.0, k2)
    phat = _div_real(-acc, k2s)
    phat[0, 0, 0] = 0.0                       # zero-mean pressure gauge
    p = torch.fft.irfftn(phat, s=cfg.shape, dim=_DIMS)
    return torch.stack([p, u[0], u[1], u[2]]).reshape(4, cfg.n_points)


def partition_snapshot(fields: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """Domain-decompose a [4, N] snapshot into [n_ranks, 4, N/n_ranks]
    contiguous slabs — each "rank"'s contribution, sent with its own
    key."""
    c, npts = fields.shape
    if npts % n_ranks:
        raise ValueError(f"{npts} points not divisible by {n_ranks} ranks")
    return fields.reshape(c, n_ranks, npts // n_ranks).permute(1, 0, 2)
