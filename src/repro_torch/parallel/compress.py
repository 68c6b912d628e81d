"""Gradient compression: the int8 wire of the DDP all-reduce.

Port of ``src/repro/parallel/compress.py``:

* :func:`quantize_int8` / :func:`dequantize_int8` — per-block symmetric
  int8 with fp32 scales (blocks of ``block`` values of the flattened
  tensor, the tail zero-padded): a quarter of the fp32 wire.
* :class:`ErrorFeedback` — the host-side residual: the quantization
  error of step *t* is added back to the gradient of step *t + 1*.
* :func:`compressed_psum_mean` — the DDP gradient sync of ``ddp="int8"``:
  each rank quantizes its gradient, the int8 payloads are summed in int32
  and the scales in fp32 (two ``collectives.psum`` calls for a whole
  tree), and the sum is dequantized with the ranks' mean scale and
  divided by the rank count.  Biased per step by design: the reference
  dequantizes with the mean scale, and so does the port.
* :func:`compressed_psum_mean_ef` — the same wire with error feedback:
  each rank adds its residual before quantizing and keeps, as its new
  residual, what its own int8 contribution dropped.
* :func:`compressed_allreduce` — the standalone form over gradients
  stacked on a leading rank axis.

The reference's forms run inside a ``shard_map`` over a named axis; the
port's take one value per rank of a :class:`~.sharding.Mesh`, as
``collectives.psum`` does, and return ``{device: mean}``.  The
reference computes all of this outside any Pallas kernel, and so does
the port: plain PyTorch on the gradients' devices.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from ..tree import tree_leaves, tree_map
from . import collectives as C
from .sharding import Mesh

__all__ = ["QTensor", "quantize_int8", "dequantize_int8", "ErrorFeedback",
           "compressed_psum_mean", "compressed_psum_mean_ef",
           "compressed_allreduce", "compression_ratio"]


class QTensor(NamedTuple):
    q: torch.Tensor        # int8 [blocks, block]
    scale: torch.Tensor    # fp32 [blocks, 1]


def quantize_int8(x: torch.Tensor, block: int = 256) -> QTensor:
    """``x`` flattened, zero-padded to whole blocks, each block scaled by
    its max magnitude / 127 (at least 1e-12) and rounded half to even."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def dequantize_int8(qt: QTensor, shape, dtype=torch.float32) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    flat = (qt.q.to(torch.float32) * qt.scale).reshape(-1)
    return flat[:n].reshape(tuple(shape)).to(dtype)


def compression_ratio(x: torch.Tensor, block: int = 256) -> float:
    """fp32 bytes over the wire's bytes (int8 payload + one fp32 scale a
    block, counted as the reference counts them)."""
    raw = x.numel() * 4
    comp = x.numel() * 1 + (x.numel() // block + 1) * 4
    return raw / comp


class ErrorFeedback:
    """Residual error feedback for a biased compressor (host-side
    state)."""

    def __init__(self):
        self.residual: Any = None

    def compress(self, grads: Any, block: int = 256):
        """``(QTensors, dequantized)`` of ``grads`` plus the residual so
        far; the new residual is what the int8 rounding dropped."""
        if self.residual is not None:
            grads = tree_map(lambda g, r: g + r.to(g.dtype), grads,
                             self.residual)
        qts = tree_map(lambda g: quantize_int8(g, block), grads)
        # the grads' tree drives the walk, so each QTensor comes whole
        deq = tree_map(lambda g, qt: dequantize_int8(qt, g.shape, g.dtype),
                       grads, qts)
        self.residual = tree_map(lambda g, d: g - d, grads, deq)
        return qts, deq


def _wire(per_rank: Sequence, mesh: Mesh, block: int):
    """The int8 wire for one tree a rank: quantize each leaf, ``psum``
    the payloads in int32 (one call for the tree) and the scales (one
    call), dequantize with the mean scale → ``({device: mean tree},
    [rank] tree of QTensors)``."""
    n = mesh.size
    # every walk is driven by a gradient tree, so each QTensor comes whole
    qts = [tree_map(lambda g: quantize_int8(g, block), g_r)
           for g_r in per_rank]
    qsum = C.psum([tree_map(lambda g, qt: qt.q.to(torch.int32), g_r, q_r)
                   for g_r, q_r in zip(per_rank, qts)], mesh)
    ssum = C.psum([tree_map(lambda g, qt: qt.scale, g_r, q_r)
                   for g_r, q_r in zip(per_rank, qts)], mesh)
    like = per_rank[0]

    def mean(q, s, g):
        m = (q.to(torch.float32) * (s / n)) / n
        return m.reshape(-1)[:g.numel()].reshape(g.shape).to(g.dtype)

    out = {d: tree_map(mean, qsum[d], ssum[d], tree_map(
        lambda g: g.to(d), like)) for d in qsum}
    return out, qts


def compressed_psum_mean(per_rank: Sequence, mesh: Mesh,
                         block: int = 256) -> dict:
    """The int8-wire mean of one gradient tree a rank of ``mesh`` →
    ``{device: mean tree}``: a quarter of the fp32 traffic, biased per
    step by the shared scale (see :func:`compressed_psum_mean_ef`)."""
    return _wire(per_rank, mesh, block)[0]


def compressed_psum_mean_ef(per_rank: Sequence, residuals: Sequence,
                            mesh: Mesh, block: int = 256
                            ) -> tuple[dict, list]:
    """:func:`compressed_psum_mean` with error feedback: rank ``r`` sends
    ``grads[r] + residuals[r]`` and keeps, as its new residual, that
    compensated gradient minus its own dequantized int8 contribution.
    ``residuals`` (one tree a rank, zeros at an epoch's start) are the
    caller's carry.  Returns ``({device: mean tree}, [rank] residual
    tree)``."""
    comp = [tree_map(lambda g, r: g + r.to(g.dtype), g_r, r_r)
            for g_r, r_r in zip(per_rank, residuals)]
    mean, qts = _wire(comp, mesh, block)
    resid = [tree_map(_residual, c_r, qt_r) for c_r, qt_r in zip(comp, qts)]
    return mean, resid


def _residual(c: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``c - dequantize_int8(qt)`` rounded once, as the reference's fused
    epoch computes it (XLA contracts the product and the difference into
    one fused multiply-add): ``q · scale`` is exact in float64 (8 bits
    times 24), and so is its difference from ``c``, the two being within
    a quantization step of each other."""
    exact = (qt.q.to(torch.float64) * qt.scale.to(torch.float64)) \
        .reshape(-1)[:c.numel()].reshape(c.shape)
    return (c.to(torch.float64) - exact).to(c.dtype)


def compressed_allreduce(grad_stack: Any, mesh: Mesh,
                         block: int = 256) -> dict:
    """The int8-wire mean of gradients stacked on a leading rank axis
    (every leaf ``[mesh.size, ...]``; rank ``r``'s slice sent from its
    device) → ``{device: mean tree}``, leaves ``[...]``.  Biased per step:
    pair it with :class:`ErrorFeedback`."""
    n = {leaf.shape[0] for leaf in tree_leaves(grad_stack)}
    if n != {mesh.size}:
        raise ValueError(f"leading rank axes {sorted(n)} for a mesh of "
                         f"{mesh.size} ranks")
    per_rank = [tree_map(lambda t: t[r].to(d), grad_stack)
                for r, d in enumerate(mesh.devices)]
    return compressed_psum_mean(per_rank, mesh, block)
