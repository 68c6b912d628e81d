"""Public entry point for the QuadConv contraction.

Port of ``src/repro/kernels/quadconv/ops.py``:

    quadconv_contract(f, w, g, mode=None)
        out[b, j, o] = Σ_{i,c} w[i] · G[j, i, o, c] · f[b, i, c]

``mode=None`` dispatches on the device of ``f``: CPU tensors take the plain
einsum (``ref.py``), CUDA tensors launch the hand-written kernel in
``csrc/quadconv.cu`` or raise — there is no fallback.  ``mode="ref"`` asks
for the plain einsum on any device (the reference the kernel is held to on
the card, as the JAX package's ``mode="ref"``).  The kernel reads ``g`` in
its native ``[J, I, O, C]`` layout, so no transpose or padding happens
here.

The kernel splits the reduction over i into chunks, gives each SM an
equal run of the (chunk, j tile) items' ring stages, and streams G
through a TMA ring (see the source).  :func:`_split_plan` picks the
chunks, the runs and the ring from the shape and the card's SM count —
never from B, so a row's bits do not depend on the batch it rides in.
The wrapper allocates the partials' workspace ``[2 S, B, J, O]`` (16.8
MB at serving block 0, 1 MB at I = J = 512), and the C entry runs a
second, small kernel that sums it in order; ``QUADCONV.launches`` counts
one per contraction.

The contraction is a ``torch.autograd.Function``.  Its backward is the
reference's own VJP (``_bwd``, three einsums — not a Pallas kernel there
either), with the shared intermediate ``t[b,i,c] = Σ_{j,o} G[j,i,o,c]
ct[b,j,o]`` computed once:

    df[b,i,c]   = w[i] · t[b,i,c]
    dw[i]       = Σ_{b,c} f[b,i,c] · t[b,i,c]
    dG[j,i,o,c] = Σ_b ct[b,j,o] · w[i] · f[b,i,c]

Both big contractions are torch products; ``t`` reads G once through a
transposed copy that ``torch.einsum`` makes (G's size, freed on return).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from .. import _build
from .ref import quadconv_contract_ref

__all__ = ["quadconv_contract", "QUADCONV"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = _build.Library("quadconv",
                      Path(__file__).parent / "csrc" / "quadconv.cu")
#: ``kernel.py::quadconv_matmul`` on Hopper (see ``csrc/quadconv.cu``).
QUADCONV = _build.Kernel(_LIB, "quadconv_contract",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P])

# The kernel's fixed shapes (csrc/quadconv.cu): batch rows per group,
# output points j per work item, floats of G per point j in a ring stage,
# consumer warps; and Hopper's shared memory per block.
_MAX_B, _J_TILE, _STAGE_FLOATS, _CONSUMER_WARPS = 8, 4, 1024, 8
_SMEM_BLOCK = 232_448
#: staged f floats per batch row in one chunk (L·C): bounds the chunk
_FW_FLOATS = 4096
_MAX_STAGES = 8


@dataclass(frozen=True)
class SplitPlan:
    """How the kernel cuts one contraction: ``splits`` chunks of
    ``chunk`` rows of i (the last may be shorter) times ``tiles`` tiles of
    4 output points j are the work items.  Their ``units`` ring stages of
    ``rows`` rows of i are cut into ``grid`` equal runs, one per block;
    ``stages`` ring stages fill the shared memory left."""
    I: int
    rows: int
    chunk: int
    splits: int
    tiles: int
    stages: int
    grid: int

    @property
    def items(self) -> int:
        return self.tiles * self.splits

    @property
    def units(self) -> int:
        return self.tiles * max(1, -(-self.I // self.rows))

    def balance(self, n_sm: int) -> float:
        """Busy share of ``n_sm`` SMs: the mean run over the longest."""
        return self.units / (n_sm * -(-self.units // self.grid))

    def chunks(self) -> list[tuple[int, int]]:
        return [(s * self.chunk, min(self.I, (s + 1) * self.chunk))
                for s in range(self.splits)]


def _smem_bytes(O: int, C: int, chunk: int, stages: int) -> int:
    """Dynamic shared memory of the kernel (``smem_bytes`` in the source):
    the ring, the staged f and w, the partials, the mbarriers."""
    groups = min(_STAGE_FLOATS // (O * C), _CONSUMER_WARPS)
    return 4 * (stages * _J_TILE * _STAGE_FLOATS + _MAX_B * chunk * C
                + chunk + groups * _J_TILE * _MAX_B * O) + 16 * stages


@functools.lru_cache(maxsize=None)
def _split_plan(I: int, J: int, O: int, C: int, n_sm: int,
                fw_floats: int = _FW_FLOATS) -> SplitPlan:
    """The split of one contraction for a card with ``n_sm`` SMs.

    A chunk holds at most ``fw_floats // C`` rows of i (its staged f) and
    is a whole number of ring stages.  There are as few chunks as that
    allows, but at least enough that the items outnumber the SMs where i
    is long enough.  The blocks' runs are at least one item long, so a
    run's end cuts an item once at most.  B plays no part."""
    rows = _STAGE_FLOATS // (O * C)
    tiles = -(-J // _J_TILE)
    n_stages = max(1, -(-I // rows))             # ring stages along i
    per_chunk = max(1, fw_floats // C // rows)   # stages a chunk may hold
    splits = min(n_stages, max(-(-n_stages // per_chunk), -(-n_sm // tiles)))
    k = -(-n_stages // splits)                   # stages per chunk
    splits = -(-n_stages // k)
    fixed = _smem_bytes(O, C, k * rows, 0)
    per_stage = _smem_bytes(O, C, 0, 1) - _smem_bytes(O, C, 0, 0)
    return SplitPlan(I=I, rows=rows, chunk=k * rows, splits=splits,
                     tiles=tiles,
                     stages=min(_MAX_STAGES,
                                (_SMEM_BLOCK - fixed) // per_stage),
                     grid=min(n_sm, tiles * n_stages // k))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(f, w, g) -> None:
    b, i, c = f.shape
    j, i2, o, c2 = g.shape
    if (i, c) != (i2, c2) or w.shape != (i,):
        raise ValueError(f"quadconv_contract: f {tuple(f.shape)}, "
                         f"w {tuple(w.shape)}, g {tuple(g.shape)}")
    oc = o * c
    if c % 4 or c > 128 or oc < 4 or oc > 1024 or oc & (oc - 1):
        raise ValueError(f"quadconv kernel takes C % 4 == 0, C <= 128 and "
                         f"O*C a power of two in [4, 1024]; got O={o}, C={c}")
    for name, t in (("f", f), ("w", w), ("g", g)):
        if t.device != f.device:
            raise ValueError(f"quadconv_contract: {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"quadconv kernel takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"quadconv kernel: {name} must be contiguous "
                             "and 16-byte aligned")


def quadconv_contract(f: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      mode: str | None = None) -> torch.Tensor:
    """out[b,j,o] = Σ_{i,c} w[i] G[j,i,o,c] f[b,i,c].  See module docstring."""
    if mode not in (None, "ref"):
        raise ValueError(f"unknown quadconv mode {mode!r} (None or 'ref')")
    return _Contract.apply(f, w, g, mode)


class _Contract(torch.autograd.Function):
    """The contraction with the reference's einsum VJP."""

    @staticmethod
    def forward(ctx, f, w, g, mode):
        ctx.save_for_backward(f, w, g)
        return _forward(f, w, g, mode)

    @staticmethod
    def backward(ctx, ct):
        f, w, g = ctx.saved_tensors
        need_f, need_w, need_g = ctx.needs_input_grad[:3]
        df = dw = dg = None
        if need_f or need_w:
            t = torch.einsum("jioc,bjo->bic", g, ct)
            if need_f:
                df = t * w[None, :, None]
            if need_w:
                dw = torch.einsum("bic,bic->i", f, t)
        if need_g:
            dg = torch.einsum("bjo,bic->jioc", ct, f * w[None, :, None])
        return df, dw, dg, None


def _forward(f, w, g, mode):
    if mode == "ref" or f.device.type == "cpu":
        return quadconv_contract_ref(f, w, g)
    if f.device.type != "cuda":
        raise ValueError(f"quadconv_contract: no kernel for {f.device}")
    _check(f, w, g)
    n_sm = _sm_count(_index(f.device))
    return _launch(f, w, g, _plan(f.shape, g.shape, n_sm))


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _plan(f_shape, g_shape, n_sm: int) -> SplitPlan:
    """The wrapper's plan for f [B, I, C] and g [J, I, O, C]: B is not
    passed on."""
    j, i, o, c = g_shape
    return _split_plan(i, j, o, c, n_sm)


def _launch(f, w, g, plan: SplitPlan, grid: int | None = None):
    """One launch of the kernel with ``plan`` (on ``grid`` runs instead of
    the plan's, if given: at most ``plan.units // (chunk // rows)``)."""
    b, i, _ = f.shape
    j, _, o, c = g.shape
    if not (b and j and i):
        return torch.zeros((b, j, o), dtype=torch.float32, device=f.device)
    out = torch.empty((b, j, o), dtype=torch.float32, device=f.device)
    ws = torch.empty((2 * plan.splits, b, j, o), dtype=torch.float32,
                     device=f.device)
    QUADCONV.launch(f.data_ptr(), w.data_ptr(), g.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), b, i, j, o, c,
                    plan.chunk, plan.splits, plan.stages, grid or plan.grid,
                    _P(torch.cuda.current_stream(f.device).cuda_stream))
    return out
