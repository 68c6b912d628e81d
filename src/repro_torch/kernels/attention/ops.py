"""Public entry for flash attention: the hand-written kernel on the card,
the plain version on the CPU.

Port of ``src/repro/kernels/attention/ops.py`` and ``kernel.py``:

* ``flash_attention(q, k, v, causal, return_lse)`` — the kernel's own
  entry (``kernel.py::flash_attention``), with its shape contract: ``S``
  and ``T`` must be multiples of ``min(128, S)`` and ``min(128, T)``, the
  reference's tiles, or it raises ``ValueError``.  A CPU tensor takes the
  plain version (``ref.flash_attention_ref``); a CUDA tensor launches
  ``csrc/attention.cu`` or raises — there is no fallback.
* ``mha(q, k, v, causal, mode)`` — what the model calls.  ``mode=None``
  (or ``"interpret"``, the reference's CPU-test mode, accepted as its
  alias) dispatches on the device: the CPU takes ``mha_ref``, as the
  reference does off the TPU; CUDA launches the kernel.  ``mode="ref"``
  asks for ``mha_ref`` on any device.

Forward only: the reference's ``custom_vjp`` runs the two Pallas backward
kernels (``bwd.py``), which are ``ROADMAP.md`` B4/B5, so a CUDA call that
needs a gradient raises ``NotImplementedError``.  A CPU call
differentiates ``mha_ref`` by autograd.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import flash_attention_ref, mha_ref

__all__ = ["mha", "flash_attention", "FLASH"]

BLK = 128        # the reference kernel's tiles, which fix the shape contract

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = _build.Library("attention",
                      Path(__file__).parent / "csrc" / "attention.cu")
#: ``kernel.py::flash_attention`` on Hopper (see ``csrc/attention.cu``).
FLASH = _build.Kernel(_LIB, "flash_attention_fwd",
                      [_P, _P, _P, _P, _P] + [_I] * 6 + [_L] * 9
                      + [_I, ctypes.c_float, _I, _P])


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    S, T = q.shape[1], k.shape[1]
    blk_q, blk_k = min(BLK, S), min(BLK, T)
    if S % blk_q or T % blk_k:
        raise ValueError(f"S={S}/T={T} must divide blocks ({blk_q},{blk_k})")


def _launch(q, k, v, causal: bool):
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q {q.dtype} on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, not "
                        f"{q.dtype}")
    if dh % 4 or dh > 128:
        raise ValueError(f"flash kernel takes dh a multiple of 4, <= 128; "
                         f"got {dh}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel: the last axis must be contiguous")
    o = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    FLASH.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, S, T, H, K, dh, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], int(causal),
                 1.0 / (dh ** 0.5), int(q.dtype == torch.bfloat16),
                 _P(torch.cuda.current_stream(q.device).cuda_stream))
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, return_lse: bool = False):
    """q: [B,S,H,dh]; k,v: [B,T,K,dh] → [B,S,H,dh] (+ LSE fp32 [B,S,H])."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        o, lse = flash_attention_ref(q, k, v, causal)
    elif q.device.type == "cuda":
        o, lse = _launch(q, k, v, causal)
    else:
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return (o, lse) if return_lse else o


def mha(q, k, v, causal: bool = True, mode: str | None = None):
    """Causal GQA attention, forward.  See the module docstring."""
    if mode not in (None, "interpret", "ref"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if mode == "ref" or q.device.type == "cpu":
        return mha_ref(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention's backward kernels (dq; dk/dv) are "
            "ROADMAP.md B4/B5: the CUDA path is forward only")
    return flash_attention(q, k, v, causal)
