"""Public entry for flash attention: the hand-written kernels on the card,
the plain versions on the CPU.

Port of ``src/repro/kernels/attention/ops.py``, ``kernel.py`` and
``bwd.py``:

* ``flash_attention(q, k, v, causal, return_lse)`` — the forward kernel's
  own entry (``kernel.py::flash_attention``), with its shape contract:
  ``S`` and ``T`` must be multiples of ``min(128, S)`` and ``min(128, T)``,
  the reference's tiles, or it raises ``ValueError``.  A CPU tensor takes
  the plain version (``ref.flash_attention_ref``); a CUDA tensor launches
  a kernel or raises — there is no fallback.  Which kernel is a rule of
  dtype and dh alone (``tensor_core_route``): bf16 with dh a multiple of
  16 up to 192 (Nemotron-4's head) takes the wgmma kernel
  ``csrc/attention_tc.cu`` (``FLASH_TC``); fp32, and bf16 with any other
  dh up to 256, the fp32-FMA kernel ``csrc/attention.cu`` (``FLASH``).
* ``flash_attention_bwd(q, k, v, o, do, lse, causal)`` — the two backward
  kernels (``bwd.py::flash_attention_bwd``: dq, then dk/dv), with the same
  shape contract, in the forward's layout (q, o, do ``[B,S,H,dh]``, k, v
  ``[B,T,K,dh]``, lse ``[B,S,H]``; the reference's entry takes the
  head-major, KV-expanded layout its ``ops.py`` builds).  dk and dv come
  back per kv head: the kernels sum the G query heads of a kv head
  inside one block, where the reference expands K/V and group-sums
  afterwards.  A CPU tensor takes ``ref.flash_attention_bwd_ref``; a CUDA
  tensor launches both kernels or raises.  Both follow the forward's rule:
  on the tensor-core route the wgmma kernels of
  ``csrc/attention_bwd_tc.cu`` (``FLASH_BWD_DQ_TC``, ``FLASH_BWD_DKV_TC``),
  else the FMA kernels of ``csrc/attention_bwd.cu`` (``FLASH_BWD_DQ``,
  ``FLASH_BWD_DKV``).
* ``mha(q, k, v, causal, mode)`` — what the model calls, differentiable
  like the reference's ``custom_vjp``: the forward saves (q, k, v, o,
  LSE) and the backward runs ``flash_attention_bwd``.  On a CUDA tensor
  (``mode`` None or ``"interpret"``) that is the three kernels.  On the
  CPU, ``mode=None`` takes ``mha_ref`` differentiated by autograd, as the
  reference does off the TPU, and ``mode="interpret"`` (the reference's
  CPU-test mode, what ``attn_impl="flash_interpret"`` passes) runs the
  same autograd Function over the plain versions.  ``mode="ref"`` asks
  for ``mha_ref`` on any device.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref, mha_ref

__all__ = ["mha", "flash_attention", "flash_attention_bwd", "FLASH",
           "FLASH_TC", "FLASH_BWD_DQ", "FLASH_BWD_DQ_TC", "FLASH_BWD_DKV",
           "FLASH_BWD_DKV_TC", "tensor_core_route", "bwd_kernels"]

BLK = 128        # the reference kernel's tiles, which fix the shape contract

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_CSRC = Path(__file__).parent / "csrc"
_LIB = _build.Library("attention", _CSRC / "attention.cu")
_BWD_LIB = _build.Library("attention_bwd", _CSRC / "attention_bwd.cu")
_TC_LIB = _build.Library("attention_tc", _CSRC / "attention_tc.cu")
_BWD_TC_LIB = _build.Library("attention_bwd_tc", _CSRC / "attention_bwd_tc.cu")
_FWD_ARGS = [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I, ctypes.c_float]
#: ``kernel.py::flash_attention`` on Hopper in fp32 FMA (see
#: ``csrc/attention.cu``): fp32, and bf16 off the tensor-core route.
FLASH = _build.Kernel(_LIB, "flash_attention_fwd", _FWD_ARGS + [_I, _P])
#: ``kernel.py::flash_attention`` on Hopper's tensor cores in bf16 (see
#: ``csrc/attention_tc.cu``).
FLASH_TC = _build.Kernel(_TC_LIB, "flash_attention_fwd_tc", _FWD_ARGS + [_P])
_BWD_ARGS = [_I] * 6 + [_L] * 12 + [_I, ctypes.c_float]
#: ``bwd.py::_dq_kernel`` on Hopper in fp32 FMA (see
#: ``csrc/attention_bwd.cu``): fp32, and bf16 off the tensor-core route.
FLASH_BWD_DQ = _build.Kernel(_BWD_LIB, "flash_attention_bwd_dq",
                             [_P] * 7 + _BWD_ARGS + [_I, _P])
#: ``bwd.py::_dq_kernel`` on Hopper's tensor cores in bf16 (see
#: ``csrc/attention_bwd_tc.cu``).
FLASH_BWD_DQ_TC = _build.Kernel(_BWD_TC_LIB, "flash_attention_bwd_dq_tc",
                                [_P] * 7 + _BWD_ARGS + [_P])
#: ``bwd.py::_dkv_kernel`` on Hopper in fp32 FMA (see
#: ``csrc/attention_bwd.cu``).
FLASH_BWD_DKV = _build.Kernel(_BWD_LIB, "flash_attention_bwd_dkv",
                              [_P] * 8 + _BWD_ARGS + [_I, _P])
#: ``bwd.py::_dkv_kernel`` on Hopper's tensor cores in bf16 (see
#: ``csrc/attention_bwd_tc.cu``).
FLASH_BWD_DKV_TC = _build.Kernel(_BWD_TC_LIB, "flash_attention_bwd_dkv_tc",
                                 [_P] * 8 + _BWD_ARGS + [_P])


#: the largest head dim of each route's kernels: the tensor-core ones are
#: instantiated at 64, 128 and 192 columns, the FMA ones hold up to 256
MAX_DH_TC, MAX_DH = 192, 256


def tensor_core_route(dtype: torch.dtype, dh: int) -> bool:
    """The rule that picks a kernel, from dtype and dh alone: bf16 with dh
    a multiple of 16 up to ``MAX_DH_TC`` runs on the tensor cores
    (``FLASH_TC``, ``FLASH_BWD_DQ_TC``, ``FLASH_BWD_DKV_TC``); everything
    else on the fp32-FMA kernels."""
    return dtype == torch.bfloat16 and dh % 16 == 0 and dh <= MAX_DH_TC


def bwd_kernels(dtype: torch.dtype, dh: int) -> tuple:
    """The backward's (dq, dk/dv) kernels, by ``tensor_core_route``."""
    if tensor_core_route(dtype, dh):
        return FLASH_BWD_DQ_TC, FLASH_BWD_DKV_TC
    return FLASH_BWD_DQ, FLASH_BWD_DKV


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


def _check_kernel_inputs(q, **others) -> None:
    """What the CUDA kernels take: one device and dtype (fp32 or bf16),
    dh a multiple of 4 up to ``MAX_DH``, every last axis contiguous."""
    for name, t in others.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q {q.dtype} on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, not "
                        f"{q.dtype}")
    dh = q.shape[3]
    if dh % 4 or dh > MAX_DH:
        raise ValueError(f"flash kernel takes dh a multiple of 4, <= "
                         f"{MAX_DH}; got {dh}")
    if q.stride(3) != 1 or any(t.stride(3) != 1 for t in others.values()):
        raise ValueError("flash kernel: the last axis must be contiguous")


def _check_rows_aligned(**tensors) -> None:
    """The tensor-core kernels copy rows in 16-byte pieces."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"flash tensor-core kernel: {name}'s rows are "
                             f"not 16-byte aligned (strides {t.stride()})")


def _stream(t):
    return _P(torch.cuda.current_stream(t.device).cuda_stream)


def _launch(q, k, v, causal: bool):
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    _check_kernel_inputs(q, k=k, v=v)
    o = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, T, H, K, dh, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], int(causal), 1.0 / (dh ** 0.5))
    if tensor_core_route(q.dtype, dh):
        _check_rows_aligned(q=q, k=k, v=v)
        FLASH_TC.launch(*args, _stream(q))
    else:
        FLASH.launch(*args, int(q.dtype == torch.bfloat16), _stream(q))
    return o, lse


def _launch_bwd(q, k, v, o, do, lse, causal: bool):
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    _check_kernel_inputs(q, k=k, v=v, o=o, do=do)
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash backward: lse is {lse.dtype} on "
                         f"{lse.device}; it takes the forward's fp32 LSE")
    lse = lse.contiguous()
    # D = rowsum(do ∘ o) in fp32, a plain reduction as at bwd.py:121
    delta = (do.float() * o.float()).sum(-1)
    dq = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, T, K, dh), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, T, K, dh), dtype=v.dtype, device=q.device)
    shape = (B, S, T, H, K, dh, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *do.stride()[:3], int(causal),
             1.0 / (dh ** 0.5))
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    if tensor_core_route(q.dtype, dh):
        _check_rows_aligned(q=q, k=k, v=v, do=do)
        tail = (_stream(q),)
    else:       # the FMA kernels take the element type
        tail = (int(q.dtype == torch.bfloat16), _stream(q))
    dq_kernel, dkv_kernel = bwd_kernels(q.dtype, dh)
    dq_kernel.launch(*common, dq.data_ptr(), *shape, *tail)
    dkv_kernel.launch(*common, dk.data_ptr(), dv.data_ptr(), *shape, *tail)
    return dq, dk, dv


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


def flash_attention_bwd(q, k, v, o, do, lse, causal: bool = True):
    """→ (dq [B,S,H,dh], dk [B,T,K,dh], dv [B,T,K,dh]) in the inputs'
    dtypes; o and do like q, lse fp32 [B,S,H] (the forward's)."""
    _check_shapes(q, k, v)
    B, S, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, S, H):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, o, do, lse, causal)
    raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")


class _FlashMHA(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``ops.py:35-78``): the forward
    saves (q, k, v, o, LSE); the backward recomputes P from the LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention(q, k, v, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # the cotangent may arrive with a strided last axis after the
        # model's reshapes; the kernels read it row by row
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         ctx.causal)
        return dq, dk, dv, None


def mha(q, k, v, causal: bool = True, mode: str | None = None):
    """Causal GQA attention.  See the module docstring."""
    if mode not in (None, "interpret", "ref"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if mode == "ref" or (mode is None and q.device.type == "cpu"):
        return mha_ref(q, k, v, causal)
    return _FlashMHA.apply(q, k, v, causal)
