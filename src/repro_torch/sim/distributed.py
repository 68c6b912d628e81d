"""Domain-decomposed finite-difference incompressible solver (2-D).

Port of ``src/repro/sim/distributed.py``: the PHASTA-shaped producer the
paper couples to, a structured-grid Navier–Stokes solver whose grid rows
are cut over a ``space`` mesh axis.  Each rank advances only its own rows
plus a width-1/width-2 halo moved by :func:`~.halo.halo_exchange`
(``collectives.ppermute``), never a global collective, and its snapshots
are emitted rank-local too: each rank's ``[2, n/D, n]`` block, as an
:class:`~repro_torch.parallel.sharding.ElemShards` whose layout is the
producer's ``elem_sharding``, which a co-located store writes into each
rank's slab shard as it is (the ``capture_scan_sharded`` tier).

Numerics — Chorin projection on a periodic ``n x n`` collocated grid
(``h = 2*pi/n``), rows (dim 0) cut over the mesh, exactly the reference's:

1. explicit advection + diffusion with central differences → ``(u*, v*)``;
2. pressure Poisson ``L phi = div(u*, v*) / dt`` solved by
   ``jacobi_iters`` Jacobi sweeps of the wide Laplacian ``Dx Dx + Dy Dy``;
3. correction ``u = u* - dt * Dx phi`` (central gradient).

The discrete Taylor–Green vortex decays at ``1 - 2 nu dt lambda_h`` a
step (:func:`taylor_green_factor`).

The sharded and single-device paths share one stencil (:func:`_advance`),
which works on a list of row blocks, one per rank, and is parameterized
only by the exchange: the single-device step pads its one block with
:func:`~.halo.pad_reference`, the sharded step pads every rank's block by
:func:`~.halo.halo_exchange`.  Every operation is elementwise, a roll
along the whole columns or a copy, so the two agree bit for bit on one
device.  A sharded state holds ``u`` and ``v`` as tuples of per-rank
blocks and its clock (``t``, ``step``) on rank 0's device.

Differences from the reference, both deliberate: :func:`decaying_turbulence`
takes its ``[n, n]`` standard-normal noise as a tensor (JAX's threefry
draw cannot be reproduced; :func:`draw_noise` draws one from a
``torch.Generator``), and :func:`make_producer` takes that noise instead
of a key.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..core.store import make_key
from ..device import resolve_device
from ..parallel.sharding import ElemSharding, ElemShards, Mesh
from .halo import halo_exchange, pad_reference

__all__ = ["FDConfig", "FDState", "taylor_green", "decaying_turbulence",
           "draw_noise", "make_step", "make_producer", "shard_state",
           "unshard_state", "taylor_green_factor", "energy",
           "max_divergence", "snapshot"]


@dataclass(frozen=True)
class FDConfig:
    """Static solver configuration (grid, fluid, time step, Poisson)."""

    n: int = 32               # grid points per side (periodic box 2*pi)
    nu: float = 0.01          # kinematic viscosity
    dt: float = 2e-3          # explicit Euler time step
    jacobi_iters: int = 64    # pressure Poisson sweeps per step

    def __post_init__(self):
        if self.n < 4:
            raise ValueError("n must be >= 4")
        if self.nu <= 0:
            raise ValueError("nu must be > 0")
        if self.dt <= 0:
            raise ValueError("dt must be > 0")
        if self.jacobi_iters < 1:
            raise ValueError("jacobi_iters must be >= 1")

    @property
    def h(self) -> float:
        return 2.0 * math.pi / self.n

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    def validate_shards(self, n_shards: int, axis: str = "space") -> None:
        """Fail fast on a grid/mesh mismatch: every rank must own an equal
        block of rows."""
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.n % n_shards != 0:
            example = self.n - self.n % n_shards or n_shards * 4
            raise ValueError(
                f"grid rows n={self.n} do not divide over the "
                f"{n_shards}-shard {axis!r} mesh axis: each shard must own "
                f"an equal n/{n_shards} row block — pick n a multiple of "
                f"the shard count (e.g. n={example})")


class FDState(NamedTuple):
    """Solver state: velocity fields plus the clock.  Whole: ``u``/``v``
    are ``[n, n]`` tensors; sharded (:func:`shard_state`): tuples of the
    ranks' ``[n/D, n]`` row blocks."""

    u: torch.Tensor | tuple
    v: torch.Tensor | tuple
    t: torch.Tensor      # f32 scalar: physical time
    step: torch.Tensor   # i32 scalar: step count


def _is_sharded(state: FDState) -> bool:
    return isinstance(state.u, tuple)


def _clock(device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# Initializers (built on the whole grid; shard_state cuts them)
# ---------------------------------------------------------------------------

def _grid(cfg: FDConfig, device):
    x = torch.arange(cfg.n, dtype=torch.float32, device=device) * cfg.h
    return torch.meshgrid(x, x, indexing="ij")


def taylor_green(cfg: FDConfig, device=None) -> FDState:
    """The 2-D Taylor–Green vortex ``u = cos x sin y, v = -sin x cos y``
    on ``device`` (default: the card) — exactly divergence-free under
    central differences, and the scheme's analytic decay benchmark."""
    dev = resolve_device(device)
    X, Y = _grid(cfg, dev)
    return FDState(torch.cos(X) * torch.sin(Y), -torch.sin(X) * torch.cos(Y),
                   *_clock(dev))


def draw_noise(cfg: FDConfig, generator: torch.Generator,
               device=None) -> torch.Tensor:
    """The ``[n, n]`` standard normals :func:`decaying_turbulence` shapes,
    drawn from ``generator`` on its own device, moved to ``device``
    (default: the card)."""
    noise = torch.randn(cfg.shape, generator=generator,
                        device=generator.device)
    return noise.to(resolve_device(device))


def decaying_turbulence(cfg: FDConfig, noise: torch.Tensor, e0: float = 0.5,
                        k_peak: float = 4.0) -> FDState:
    """Decaying-HIT initial condition on ``noise``'s device: a band-limited
    streamfunction ``psi`` shaped from ``noise`` (``[n, n]`` standard
    normals, :func:`draw_noise`), energy peaked near ``k_peak``,
    velocities ``u = Dy psi, v = -Dx psi`` by the solver's own central
    differences (so exactly discretely divergence-free), normalized to
    kinetic energy ``e0``."""
    noise = torch.as_tensor(noise, dtype=torch.float32)
    if tuple(noise.shape) != cfg.shape:
        raise ValueError(f"noise of shape {tuple(noise.shape)} for a "
                         f"{cfg.shape} grid")
    dev = noise.device
    kx = torch.fft.fftfreq(cfg.n, d=1.0 / cfg.n, device=dev)
    k = torch.sqrt(kx[:, None] ** 2 + kx[None, :] ** 2)
    # band-limited spectrum, cut above n/4 (the wide Laplacian is blind to
    # the Nyquist checkerboard)
    amp = (k ** 2) * torch.exp(-((k / k_peak) ** 2))
    amp = torch.where((k > 0) & (k <= cfg.n / 4), amp, 0.0)
    psi = torch.fft.ifft2(torch.fft.fft2(noise) * amp).real \
        .to(torch.float32)
    h = cfg.h
    u = (torch.roll(psi, -1, 1) - torch.roll(psi, 1, 1)) / (2 * h)
    v = -(torch.roll(psi, -1, 0) - torch.roll(psi, 1, 0)) / (2 * h)
    e = 0.5 * torch.mean(u * u + v * v)
    scale = torch.sqrt(e0 / torch.clamp(e, min=1e-30))
    return FDState(u * scale, v * scale, *_clock(dev))


# ---------------------------------------------------------------------------
# The shared stencil (exchange-parameterized)
# ---------------------------------------------------------------------------

Exchange = Callable[[list, int], list]


def _advance(cfg: FDConfig, u: list, v: list,
             exchange: Exchange) -> tuple[list, list]:
    """One Chorin-projection step on the ranks' row blocks ``u``/``v``
    (lists, one block per rank).  ``exchange(blocks, width)`` pads every
    block with ``width`` halo rows along dim 0 — the ONLY place the
    decomposition enters; columns (dim 1) are whole on every rank, so their
    taps are local rolls."""
    h, dt, nu = cfg.h, cfg.dt, cfg.nu

    def derivs(fs):
        out = []
        for f, fp in zip(fs, exchange(fs, 1)):
            fx = (fp[2:] - fp[:-2]) / (2 * h)
            fxx = (fp[2:] - 2.0 * f + fp[:-2]) / (h * h)
            fy = (torch.roll(f, -1, 1) - torch.roll(f, 1, 1)) / (2 * h)
            fyy = (torch.roll(f, -1, 1) - 2.0 * f + torch.roll(f, 1, 1)) \
                / (h * h)
            out.append((fx, fy, fxx, fyy))
        return out

    us, vs = [], []
    for ub, vb, (ux, uy, uxx, uyy), (vx, vy, vxx, vyy) in zip(
            u, v, derivs(u), derivs(v)):
        us.append(ub + dt * (-(ub * ux + vb * uy) + nu * (uxx + uyy)))
        vs.append(vb + dt * (-(ub * vx + vb * vy) + nu * (vxx + vyy)))

    # divergence of the provisional field → the Poisson right-hand side,
    # taken times h^2 once (the reference's sweep recomputes it each time)
    h2_rhs = []
    for usp, vsb in zip(exchange(us, 1), vs):
        div = (usp[2:] - usp[:-2]) / (2 * h) \
            + (torch.roll(vsb, -1, 1) - torch.roll(vsb, 1, 1)) / (2 * h)
        h2_rhs.append((h * h) * (div / dt))

    # Jacobi on the wide Laplacian (diagonal -1/h^2):
    # phi <- (phi_{i+2} + phi_{i-2} + phi_{j+2} + phi_{j-2}) / 4 - h^2 rhs
    phi = [torch.zeros_like(b) for b in us]
    for _ in range(cfg.jacobi_iters):
        phi = [(pp[4:] + pp[:-4]
                + (torch.roll(p, -2, 1) + torch.roll(p, 2, 1))) * 0.25 - r
               for p, pp, r in zip(phi, exchange(phi, 2), h2_rhs)]

    u_new, v_new = [], []
    for usb, vsb, p, pp in zip(us, vs, phi, exchange(phi, 1)):
        u_new.append(usb - dt * (pp[2:] - pp[:-2]) / (2 * h))
        v_new.append(vsb - dt * (torch.roll(p, -1, 1)
                                 - torch.roll(p, 1, 1)) / (2 * h))
    return u_new, v_new


def make_step(cfg: FDConfig, mesh: Mesh | None = None,
              axis: str = "space") -> Callable[[FDState], FDState]:
    """The step ``state -> state``.

    ``mesh=None``: the single-device step on a whole state (periodic
    padding by :func:`~.halo.pad_reference`).  With a mesh: the step on a
    sharded state (:func:`shard_state`), every rank's rows on its own
    device and every stencil tap fed by :func:`~.halo.halo_exchange`,
    after checking the grid divides the mesh."""
    if mesh is None:
        def pad(fs, width):
            return [pad_reference(f, width=width, dim=0) for f in fs]

        def step(state: FDState) -> FDState:
            if _is_sharded(state):
                raise ValueError("the single-device step got a sharded "
                                 "state; build it with make_step(cfg, mesh)")
            (u,), (v,) = _advance(cfg, [state.u], [state.v], pad)
            return FDState(u, v, state.t + cfg.dt, state.step + 1)
        return step

    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r} is not {axis!r}")
    cfg.validate_shards(mesh.size, axis)

    def exchange(fs, width):
        return halo_exchange(fs, mesh, width=width, dim=0,
                             boundary="periodic")

    def sharded_step(state: FDState) -> FDState:
        if not _is_sharded(state) or len(state.u) != mesh.size:
            raise ValueError(f"the {mesh.size}-rank step needs a state "
                             f"sharded over its mesh (shard_state)")
        u, v = _advance(cfg, list(state.u), list(state.v), exchange)
        return FDState(tuple(u), tuple(v), state.t + cfg.dt,
                       state.step + 1)
    return sharded_step


def shard_state(state: FDState, mesh: Mesh, axis: str = "space") -> FDState:
    """A whole-grid state cut into row blocks over ``mesh`` (each on its
    rank's device; the clock on rank 0's)."""
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r} is not {axis!r}")
    n = state.u.shape[0]
    FDConfig(n=n).validate_shards(mesh.size, axis)
    layout = ElemSharding(mesh, (axis, None))
    home = mesh.devices[0]
    return FDState(tuple(layout.split(state.u)), tuple(layout.split(state.v)),
                   state.t.to(home), state.step.to(home))


def unshard_state(state: FDState) -> FDState:
    """The whole-grid copy of a sharded state, on rank 0's device (for
    diagnostics and tests; the solver never assembles its fields)."""
    if not _is_sharded(state):
        return state
    home = state.t.device
    return FDState(torch.cat([b.to(home) for b in state.u]),
                   torch.cat([b.to(home) for b in state.v]), state.t,
                   state.step)


def make_producer(cfg: FDConfig, mesh: Mesh | None = None,
                  axis: str = "space", init: str = "taylor_green",
                  noise: torch.Tensor | None = None, device=None):
    """Wire the solver into the in-situ data plane.

    Returns ``(step_fn, state0, elem_sharding)`` for an
    ``insitu.Producer``: ``step_fn(carry, rank, t)`` advances one step and
    emits the ``[2, n, n]`` velocity snapshot under a ``(rank 0, t)`` key.
    Without a mesh the snapshot is one tensor and ``elem_sharding`` is
    ``None``; with one it is each rank's ``[2, n/D, n]`` block, an
    ``ElemShards`` laid out by ``elem_sharding`` (``spec (None, axis,
    None)``), which carries the ``space`` axis into the store so the put
    stays rank-local (the ``capture_scan_sharded`` tier).  ``noise``
    (``decaying_turbulence``'s ``[n, n]`` draw; default: :func:`draw_noise`
    from seed 0) is ignored by ``taylor_green``.  The state is built on
    ``device`` (default: the card), or on the mesh's rank 0."""
    step = make_step(cfg, mesh, axis=axis)
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    if init == "taylor_green":
        state0 = taylor_green(cfg, dev)
    elif init == "decaying_turbulence":
        if noise is None:
            noise = draw_noise(cfg, torch.Generator().manual_seed(0), dev)
        state0 = decaying_turbulence(cfg, noise.to(dev))
    else:
        raise ValueError(f"unknown init {init!r} (have "
                         f"('taylor_green', 'decaying_turbulence'))")
    elem_sharding = None
    if mesh is not None:
        state0 = shard_state(state0, mesh, axis)
        elem_sharding = ElemSharding(mesh, (None, axis, None))

    def step_fn(carry, rank, t):
        nxt = step(carry)
        if elem_sharding is None:
            return nxt, make_key(0, t), torch.stack([nxt.u, nxt.v])
        return nxt, make_key(0, t), ElemShards(
            tuple(torch.stack([u, v]) for u, v in zip(nxt.u, nxt.v)),
            elem_sharding)

    return step_fn, state0, elem_sharding


# ---------------------------------------------------------------------------
# Diagnostics (a sharded state is assembled first, as a copy)
# ---------------------------------------------------------------------------

def taylor_green_factor(cfg: FDConfig) -> float:
    """Per-step velocity decay factor of the discrete Taylor–Green mode:
    ``1 - 2 nu dt lambda_h`` with ``lambda_h = 4 sin^2(h/2) / h^2``."""
    lam = 4.0 * math.sin(cfg.h / 2.0) ** 2 / cfg.h ** 2
    return float(1.0 - 2.0 * cfg.nu * cfg.dt * lam)


def energy(state: FDState) -> torch.Tensor:
    """Mean kinetic energy ``0.5 <u^2 + v^2>``."""
    state = unshard_state(state)
    return 0.5 * torch.mean(state.u ** 2 + state.v ** 2)


def snapshot(state: FDState) -> torch.Tensor:
    """The emitted table element, whole: stacked ``[2, n, n]``
    velocities."""
    state = unshard_state(state)
    return torch.stack([state.u, state.v])


def max_divergence(cfg: FDConfig, state: FDState) -> torch.Tensor:
    """Max |central-difference divergence| — the invariant the projection
    maintains (down to the Jacobi residual)."""
    state = unshard_state(state)
    h = cfg.h
    div = (torch.roll(state.u, -1, 0) - torch.roll(state.u, 1, 0)) / (2 * h) \
        + (torch.roll(state.v, -1, 1) - torch.roll(state.v, 1, 1)) / (2 * h)
    return torch.max(torch.abs(div))
