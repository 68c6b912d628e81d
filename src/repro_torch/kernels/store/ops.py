"""Public entry points for the store access kernels.

Port of ``src/repro/kernels/store/ops.py``.  The wrapper dispatches on the
device of the tensors it is given: CPU tensors take the plain PyTorch
version (``ref.py``); CUDA tensors launch the hand-written kernel in
``csrc/store.cu`` or raise — there is no fallback.  ``gather_rows_sharded``
belongs to a later slice (``ROADMAP.md`` B2).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import KEY_DTYPE, gather_rows_ref, probe_slots_ref, sample_slots_ref

__all__ = ["probe_slots", "gather_rows", "sample_slots",
           "gather_rows_sharded", "PROBE", "GATHER", "SAMPLE"]

_P = ctypes.c_void_p
_LIB = _build.Library("store", Path(__file__).parent / "csrc" / "store.cu")
#: ``kernel.py::probe`` on Hopper (see ``csrc/store.cu``).
PROBE = _build.Kernel(_LIB, "probe_slots",
                      [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P])
#: ``kernel.py::gather`` on Hopper (see ``csrc/store.cu``).
GATHER = _build.Kernel(_LIB, "gather_rows",
                       [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, _P])
#: ``kernel.py::sample`` on Hopper (see ``csrc/store.cu``).
SAMPLE = _build.Kernel(_LIB, "sample_slots",
                       [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P])


def _stream(t: torch.Tensor) -> _P:
    return _P(torch.cuda.current_stream(t.device).cuda_stream)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def probe_slots(table_keys: torch.Tensor, version: torch.Tensor,
                query: torch.Tensor):
    """First live slot per query key → ``(idx int32[n], found bool[n])``.

    ``idx == capacity`` (and ``found == False``) where the key is absent.
    """
    if table_keys.device.type == "cpu":
        return probe_slots_ref(table_keys, version, query)
    _check_cuda("probe_slots", table_keys, version, query)
    if (table_keys.dtype, version.dtype, query.dtype) != \
            (KEY_DTYPE, torch.int32, KEY_DTYPE):
        raise TypeError("probe_slots takes int64 keys, int32 version, "
                        f"int64 query; got {table_keys.dtype}, "
                        f"{version.dtype}, {query.dtype}")
    if table_keys.shape != version.shape or table_keys.dim() != 1 \
            or query.dim() != 1:
        raise ValueError("probe_slots: keys/version [C], query [n]")
    capacity, n = table_keys.shape[0], query.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=query.device)
    if n:
        PROBE.launch(table_keys.data_ptr(), version.data_ptr(),
                     query.data_ptr(), idx.data_ptr(), capacity, n,
                     _stream(query))
    return idx, idx < capacity


def gather_rows(slab: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``slab[slots]`` row gather; ``slots`` (int32) must be in range."""
    if slab.device.type == "cpu":
        return gather_rows_ref(slab, slots)
    _check_cuda("gather_rows", slab, slots)
    if slots.dtype != torch.int32 or slots.dim() != 1:
        raise TypeError(f"gather_rows takes int32 slots [n], got "
                        f"{slots.dtype} {tuple(slots.shape)}")
    n = slots.shape[0]
    out = torch.empty((n, *slab.shape[1:]), dtype=slab.dtype,
                      device=slab.device)
    row_bytes = out[0].numel() * out.element_size() if n else 0
    if n and row_bytes:
        GATHER.launch(slab.data_ptr(), slots.data_ptr(), out.data_ptr(),
                      row_bytes, slab.shape[0], n, _stream(slab))
    return out


def sample_slots(version: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Slot of the ``r``-th live entry per rank → ``int32[n]``:
    ``capacity`` where ``r >= nvalid``, 0 where ``r < 0``."""
    if version.device.type == "cpu":
        return sample_slots_ref(version, ranks)
    _check_cuda("sample_slots", version, ranks)
    if (version.dtype, ranks.dtype) != (torch.int32, torch.int32) \
            or version.dim() != 1 or ranks.dim() != 1:
        raise TypeError("sample_slots takes int32 version [C] and int32 "
                        f"ranks [n]; got {version.dtype} "
                        f"{tuple(version.shape)}, {ranks.dtype} "
                        f"{tuple(ranks.shape)}")
    capacity, n = version.shape[0], ranks.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=ranks.device)
    if n:
        rank_map = torch.empty(capacity, dtype=torch.int32,
                               device=version.device)
        SAMPLE.launch(version.data_ptr(), ranks.data_ptr(),
                      rank_map.data_ptr(), out.data_ptr(), capacity, n,
                      _stream(version))
    return out


def gather_rows_sharded(*_args, **_kwargs):
    raise NotImplementedError("gather_rows_sharded: ROADMAP.md B2")
