"""The mesh's collectives, as explicit functions over its ranks.

The reference's ``lax.psum``, ``all_gather`` and ``lax.ppermute``
inside a ``shard_map`` become calls that take one value per rank of a
:class:`~repro_torch.parallel.sharding.Mesh` and return one result per
distinct device (``{device: tensor}``): ranks that share a device share
its result.  The order of a sum is fixed (ascending rank), so every rank
holds the same bits.  Where ranks sit on different devices the sum is
taken on rank 0's device and then copied to the others.

On an N-D mesh ``psum`` and ``all_gather`` take ``axis=``: the collective
runs within each group of ranks that share every other coordinate
(``Mesh.groups``), each group's sum in ascending rank order on its first
rank's device, and the call returns one result per rank (``[rank]``, on
its rank's device; the ranks of a group on one device share a tensor).
A grouped call counts once, as a grouped HLO collective does.

:func:`ppermute` is the
exception: it moves one block per rank to another rank, so it takes and
returns one value per rank (``[rank]``), each on its rank's device.

``COUNTS`` counts the calls by kind (``all_reduce``, ``all_gather``,
``collective_permute``), a tree reduced in one ``psum`` counting once;
:func:`counted` gives the calls a block makes, which
``InSituSession.plan(hlo=True)`` reads for one epoch of each trainer
tier, one producer chunk and one serving drain (the port's counterpart of
counting the collectives in compiled HLO, ``collective_permute`` standing
for ``collective-permute``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Sequence

import torch

from ..tree import tree_map
from .sharding import Mesh

__all__ = ["psum", "all_gather", "ppermute", "COUNTS", "reset_counts",
           "counted"]

#: calls so far, by kind
COUNTS = {"all_reduce": 0, "all_gather": 0, "collective_permute": 0}
_lock = threading.Lock()


def reset_counts() -> None:
    with _lock:
        for k in COUNTS:
            COUNTS[k] = 0


@contextlib.contextmanager
def counted() -> Iterator[dict]:
    """Yield a dict that, once the block exits, holds the calls of each
    kind made inside it (``COUNTS``' change; calls from other threads in
    the meantime count too)."""
    with _lock:
        before = dict(COUNTS)
    calls: dict = {}
    try:
        yield calls
    finally:
        with _lock:
            calls.update({k: COUNTS[k] - before[k] for k in COUNTS})


def _count(kind: str) -> None:
    with _lock:
        COUNTS[kind] += 1


def _per_rank(values: Sequence, mesh: Mesh) -> None:
    if len(values) != mesh.size:
        raise ValueError(f"{len(values)} values for a mesh of {mesh.size} "
                         f"ranks")


def _broadcast(value, mesh: Mesh) -> dict:
    home = mesh.devices[0]
    return {d: value if d == home else tree_map(lambda t: t.to(d), value)
            for d in mesh.distinct_devices}


def _sum(values: Sequence, home):
    total = values[0]
    for value in values[1:]:
        total = tree_map(lambda a, b: a + b.to(home), total, value)
    return total


def _per_group(values: Sequence, mesh: Mesh, axis: str, reduce) -> list:
    """``reduce(group's values, its first device)`` within each group of
    ``axis``, copied to every rank of the group → one result per rank."""
    out: list = [None] * mesh.size
    for group in mesh.groups(axis):
        home = mesh.devices[group[0]]
        result = reduce([values[r] for r in group], home)
        placed = {home: result}
        for r in group:
            d = mesh.devices[r]
            if d not in placed:
                placed[d] = tree_map(lambda t: t.to(d), result)
            out[r] = placed[d]
    return out


def psum(per_rank: Sequence, mesh: Mesh, axis: str | None = None):
    """Sum of one tensor (or tree of tensors, any dtype) per rank, in
    ascending rank order, on rank 0's device → ``{device: sum}``.  With
    ``axis``: the sum within each group along that axis → ``[rank]``
    (one result per rank)."""
    _per_rank(per_rank, mesh)
    _count("all_reduce")
    if axis is not None:
        return _per_group(per_rank, mesh, axis, _sum)
    return _broadcast(_sum(per_rank, mesh.devices[0]), mesh)


def all_gather(shards: Sequence[torch.Tensor], mesh: Mesh,
               dim: int = 0, axis: str | None = None):
    """The ranks' blocks concatenated along ``dim`` (a slab's slot axis by
    default) → ``{device: whole}``.  With ``axis``: the blocks of each
    group along that axis, in its order → ``[rank]``."""
    _per_rank(shards, mesh)
    _count("all_gather")

    def cat(blocks, home):
        return torch.cat([s.to(home) for s in blocks], dim=dim)

    if axis is not None:
        return _per_group(shards, mesh, axis, cat)
    return _broadcast(cat(shards, mesh.devices[0]), mesh)


def ppermute(per_rank: Sequence[torch.Tensor], mesh: Mesh,
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
    """``lax.ppermute``: for each ``(source, dest)`` pair of ``perm``, rank
    ``dest`` receives rank ``source``'s value on its own device; a rank no
    pair names as a destination receives zeros → one value per rank."""
    _per_rank(per_rank, mesh)
    dests = [d for _, d in perm]
    if len(set(dests)) != len(dests) \
            or len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a permutation")
    _count("collective_permute")
    out: list = [None] * mesh.size
    for src, dst in perm:
        out[dst] = per_rank[src].to(mesh.devices[dst])
    return [torch.zeros_like(per_rank[r], device=mesh.devices[r])
            if o is None else o for r, o in enumerate(out)]
