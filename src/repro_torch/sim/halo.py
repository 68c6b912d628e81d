"""Width-w halo exchange over a mesh's ranks (the Swirl-LM shape).

Port of ``src/repro/sim/halo.py``.  The paper's producer is PHASTA: an
MPI-decomposed solver whose ranks advance a structured-mesh stencil and
swap only their subdomain *faces* each step.  The reference runs that
exchange inside a ``shard_map`` as a pair of ``lax.ppermute`` ops; the
port is single-controller, so a sharded field is a list of blocks, one per
rank of a :class:`~repro_torch.parallel.sharding.Mesh`, each on its rank's
device, and the two ppermutes are two
:func:`~repro_torch.parallel.collectives.ppermute` calls over the ranks'
faces (counted as ``collective_permute``).

* :func:`halo_exchange` — pad every rank's block with ``width`` rows of
  its neighbours' data along one array dim.
* :func:`halo_exchange_nd` — the 1-D/2-D replica-grid form: blocks nested
  one list level per grid axis, the axes exchanged in turn; the second
  pass moves the already-padded faces, so corner halos fill consistently
  without extra messages.
* :func:`pad_reference` — the single-device ground truth (the whole array
  padded with the same boundary semantics), used by the parity tests and
  the unsharded solver.

Boundary conditions, as in the reference: ``"periodic"`` is a cyclic
permutation (the last rank feeds the first); ``"wall"`` is non-cyclic
(ppermute zero-fills the edge ranks' missing neighbour) and the edge
ranks then fill their outer halo from their own rows: ``wall="zero"``
(Dirichlet-0 ghost), ``"reflect"`` (mirrored interior rows) or
``"reflect_neg"`` (negated mirror).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..parallel import collectives as C
from ..parallel.sharding import Mesh

__all__ = ["WALL_MODES", "halo_exchange", "halo_exchange_nd",
           "pad_reference"]

WALL_MODES = ("zero", "reflect", "reflect_neg")


def _shift_perm(n: int, shift: int, cyclic: bool) -> list[tuple[int, int]]:
    """(source, dest) pairs moving each rank's face ``shift`` ranks over
    on a 1-D axis of ``n`` ranks; a non-cyclic perm omits the wrap pair."""
    if cyclic:
        return [(i, (i + shift) % n) for i in range(n)]
    return [(i, i + shift) for i in range(n) if 0 <= i + shift < n]


def _wall_fill(x: torch.Tensor, dim: int, width: int, side: str,
               wall: str) -> torch.Tensor:
    """Ghost rows for a wall boundary, from the block's own edge rows."""
    if wall == "zero":
        shape = list(x.shape)
        shape[dim] = width
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    n = x.shape[dim]
    face = x.narrow(dim, 0 if side == "low" else n - width, width)
    face = torch.flip(face, (dim,))
    return -face if wall == "reflect_neg" else face


def _check(x, axis, width, dim, boundary, wall) -> None:
    if boundary not in ("periodic", "wall"):
        raise ValueError(f"unknown boundary {boundary!r} "
                         f"(have ('periodic', 'wall'))")
    if wall not in WALL_MODES:
        raise ValueError(f"unknown wall mode {wall!r} (have {WALL_MODES})")
    if width < 1:
        raise ValueError("halo width must be >= 1")
    if width > x.shape[dim]:
        raise ValueError(
            f"halo width {width} exceeds the local block extent "
            f"{x.shape[dim]} along dim {dim} (axis {axis!r}): each shard "
            f"must own at least `width` rows to fill its neighbor's halo")


def halo_exchange(blocks: Sequence[torch.Tensor], mesh: Mesh, *,
                  width: int = 1, dim: int = 0, boundary: str = "periodic",
                  wall: str = "zero") -> list[torch.Tensor]:
    """Pad each rank's block (``blocks[r]`` on ``mesh.devices[r]``) with
    ``width`` halo rows of its neighbours' data on both sides of array dim
    ``dim``.  Returns the blocks grown by ``2 * width`` along ``dim``, in
    rank order (a stencil slices its taps out of them; nothing is
    reassembled).  The sends are the blocks' own edge faces, so chained
    stencils re-exchange rather than trust stale halos.  Two
    ``ppermute`` calls, and nothing else, cross ranks."""
    blocks = list(blocks)
    if len(blocks) != mesh.size:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size} "
                         f"ranks")
    for x in blocks:
        _check(x, mesh.axis, width, dim, boundary, wall)
    n = mesh.size
    cyclic = boundary == "periodic"
    lo = [x.narrow(dim, 0, width) for x in blocks]
    hi = [x.narrow(dim, x.shape[dim] - width, width) for x in blocks]
    # the +1 shift carries each rank's high face into its upper
    # neighbour's LOW halo, and the -1 shift the low face the other way
    recv_lo = C.ppermute(hi, mesh, _shift_perm(n, +1, cyclic))
    recv_hi = C.ppermute(lo, mesh, _shift_perm(n, -1, cyclic))
    if not cyclic:
        recv_lo[0] = _wall_fill(blocks[0], dim, width, "low", wall)
        recv_hi[n - 1] = _wall_fill(blocks[n - 1], dim, width, "high", wall)
    return [torch.cat([a, x, b], dim=dim)
            for a, x, b in zip(recv_lo, blocks, recv_hi)]


def halo_exchange_nd(blocks, *, axes: Sequence[tuple[str, int]],
                     width: int = 1, boundary: str = "periodic",
                     wall: str = "zero"):
    """Halo exchange over a 1-D/2-D replica grid.  ``blocks`` nests one
    list level per entry of ``axes``, a sequence of ``(mesh_axis,
    array_dim)`` pairs: pass ``k`` exchanges every line of blocks along
    nesting level ``k`` (a ring of ``len(line)`` ranks on the blocks' own
    devices) along ``array_dim``.  Each pass exchanges the blocks as padded
    by the previous ones, so the corner halos hold the diagonal
    neighbour's data (no diagonal message).  Returns the padded blocks,
    nested as given."""
    shape, level = [], blocks
    for _ in axes:
        shape.append(len(level))
        level = level[0]
    grid = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        cell = blocks
        for i in idx:
            cell = cell[i]
        grid[idx] = cell
    for k, (axis, dim) in enumerate(axes):
        lines = np.moveaxis(grid, k, -1)
        for idx in np.ndindex(*lines.shape[:-1]):
            line = [lines[idx + (j,)] for j in range(lines.shape[-1])]
            mesh = Mesh(tuple(b.device for b in line), axis)
            padded = halo_exchange(line, mesh, width=width, dim=dim,
                                   boundary=boundary, wall=wall)
            for j, b in enumerate(padded):
                lines[idx + (j,)] = b
    return grid.tolist()


def pad_reference(x: torch.Tensor, *, width: int = 1, dim: int = 0,
                  boundary: str = "periodic",
                  wall: str = "zero") -> torch.Tensor:
    """Single-device ground truth: pad the *whole* array with the
    boundary semantics :func:`halo_exchange` gives the ranks at the
    domain's edges.  A stencil on this padded array equals the ranks'
    stencils on their exchanged blocks, concatenated."""
    _check(x, "<global>", width, dim, boundary, wall)
    n = x.shape[dim]
    if boundary == "periodic":
        lo = x.narrow(dim, n - width, width)
        hi = x.narrow(dim, 0, width)
    else:
        lo = _wall_fill(x, dim, width, "low", wall)
        hi = _wall_fill(x, dim, width, "high", wall)
    return torch.cat([lo, x, hi], dim=dim)
