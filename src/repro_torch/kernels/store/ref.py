"""Plain PyTorch versions of the store access kernels.

Port of ``src/repro/kernels/store/ref.py``, and like it the production
path off the card: the CUDA wrappers in ``ops.py`` take these for CPU
tensors, and ``chip_smoke.py`` holds the kernels to them on the card.  They
share the kernels' complexity contract — no ``[n, capacity]`` match
matrix: key probing sorts the slot keys once and binary-searches the
queries; sampling maps ranks onto live slots through the cumulative
live count with the same binary search.

Keys are int64 tensors carrying the uint32 key value (torch has no uint32
``searchsorted`` or ``remainder``).  Tie-break: the *lowest* live slot
holding a key wins, as in the reference.
"""

from __future__ import annotations

import torch

__all__ = ["probe_slots_ref", "sample_slots_ref", "gather_rows_ref",
           "gather_rows_sharded_ref", "EMPTY_KEY", "KEY_DTYPE"]

EMPTY_KEY = 0xFFFFFFFF
KEY_DTYPE = torch.int64


def probe_slots_ref(table_keys: torch.Tensor, version: torch.Tensor,
                    query: torch.Tensor):
    """First live slot holding each query key.

    Args:
      table_keys: int64[capacity] per-slot keys.
      version:    int32[capacity]; > 0 where the slot is live.
      query:      int64[n] keys to look up (``EMPTY_KEY`` never matches).
    Returns:
      ``(idx int32[n], found bool[n])`` — ``idx == capacity`` where absent.
    """
    capacity = table_keys.shape[0]
    masked = torch.where(version > 0, table_keys,
                         torch.full_like(table_keys, EMPTY_KEY))
    # stable sort keeps equal keys in slot order, so a left search lands
    # on the lowest matching slot
    order = torch.argsort(masked, stable=True)
    sorted_keys = masked[order]
    pos = torch.searchsorted(sorted_keys, query, side="left")
    pos_c = pos.clamp(max=capacity - 1)
    found = (sorted_keys[pos_c] == query) & (query != EMPTY_KEY) \
        & (pos < capacity)
    idx = torch.where(found, order[pos_c], capacity).to(torch.int32)
    return idx, found


def sample_slots_ref(version: torch.Tensor,
                     ranks: torch.Tensor) -> torch.Tensor:
    """Slot index of the ``r``-th live slot for each rank ``r`` (int32).

    A rank >= nvalid gives ``capacity`` and a rank < 0 gives 0 (the
    reference's ``searchsorted(cumsum(valid), r, side="right")``).
    """
    cum = torch.cumsum((version > 0).to(torch.int32), 0, dtype=torch.int32)
    return torch.searchsorted(cum, ranks.to(torch.int32), right=True,
                              out_int32=True)


def gather_rows_ref(slab: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Row gather ``slab[slots]`` (slots already clamped in range)."""
    return slab.index_select(0, slots.to(torch.int64))


def gather_rows_sharded_ref(local_slab: torch.Tensor, slots: torch.Tensor,
                            offset: int) -> torch.Tensor:
    """Shard-local row gather: ``local_slab [Cl, *elem]`` is one shard of
    the slot-sharded slab, ``slots`` are global indices, ``offset`` is the
    shard's first global slot.  Rows owned by other shards come out as
    zeros (the caller sums the shards' results)."""
    local_cap = local_slab.shape[0]
    slots = slots.to(torch.int64)
    local = (slots - offset).clamp(0, local_cap - 1)
    rows = local_slab.index_select(0, local)
    owned = (slots >= offset) & (slots < offset + local_cap)
    mask = owned.reshape((-1,) + (1,) * (local_slab.dim() - 1))
    return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                device=rows.device))
