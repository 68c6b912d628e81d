"""Port parity for the LM serving slice's kernels: flash attention and the
SSD intra-chunk step (``repro_torch``'s plain versions, what its wrappers
run for CPU tensors) against the JAX reference's Pallas kernels in
interpret mode.

Inputs come from numpy seeds.  Flash attention is held to ``TOL`` 2e-5
(rtol and atol, fp32, the reference's own ``tests/test_kernels.py``
tolerance) on three of the reference's sweep shapes — GQA 2:1, MQA over
three KV blocks, non-causal — for the output AND the log-sum-exp the
backward kernels consume; both packages refuse a sequence that is not a
multiple of the kernel's tile (S = 200).  The SSD step is held to 3e-5
(the reference's ``test_ssd_kernel_sweep`` tolerance) for ``y``, the
chunk ``state`` and ``cum``, and for the whole ``ssd_scan`` including
``h_final``.  The CUDA kernels are held to these plain versions on the
card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

The flash-attention backward's plain version (dq, dk, dv from the
forward's o and LSE) is held to the reference's two Pallas backward
kernels in interpret mode, fed the head-major, KV-expanded layout its
``ops.py`` builds and group-summed as it does, and the port's ``mha``
with ``mode="interpret"`` (its autograd Function over the plain
versions) to ``jax.grad`` of the reference's ``mha(..., "interpret")``:
on the four shapes of the reference's own backward test
(``tests/test_kernels.py``), within its tolerance, atol 1e-4.  Both
directions also run cross-attention shapes (S queries against T != S
keys, no mask), Whisper's decoder against its encoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.attention import mha as jmha
from repro.kernels.attention.bwd import flash_attention_bwd as jflash_bwd
from repro.kernels.attention.kernel import flash_attention as jflash
from repro.kernels.ssd.kernel import ssd_intra as jssd_intra
from repro.kernels.ssd.ops import ssd_scan

# one compiled program per call site instead of one per eager op
jssd_scan = jax.jit(ssd_scan, static_argnames=("chunk", "mode"))


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tattn, tssd
    import torch
    from repro_torch.kernels.attention import ops as tattn
    from repro_torch.kernels.ssd import ops as tssd
    torch.set_num_threads(1)


TOL = 2e-5
SSD_TOL = 3e-5


def _cases(shapes):
    """(B, S, T, H, K, dh, causal) rows as pytest params, each id
    B-S-H-K-dh-causal, with -T<T> appended where T != S (cross-attention:
    S queries against T keys)."""
    return [pytest.param(*c, id="-".join(map(str, (*c[:2], *c[3:])))
                         + (f"-T{c[2]}" if c[2] != c[1] else ""))
            for c in shapes]


FLASH_SHAPES = _cases([
    (2, 256, 256, 4, 2, 64, True),      # GQA 2:1
    (1, 384, 384, 2, 1, 64, True),      # MQA, 3 kv blocks
    (1, 128, 128, 4, 4, 64, False),     # bidirectional
    (1, 128, 128, 2, 1, 192, True),     # Nemotron-4's dh, MQA
    (1, 128, 128, 4, 2, 192, False),    # Nemotron-4's dh, GQA bidirectional
    (2, 32, 64, 4, 4, 16, False),       # Whisper smoke's cross-attention
    (1, 128, 384, 4, 2, 64, False),     # cross, 3 kv blocks of 128
])


def _qkv(B, S, H, K, dh, seed, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((B, S, H, dh), (B, T, K, dh), (B, T, K, dh))]


@pytest.mark.parametrize("B,S,T,H,K,dh,causal", FLASH_SHAPES)
def test_flash_attention_matches_reference(B, S, T, H, K, dh, causal):
    q, k, v = _qkv(B, S, H, K, dh, seed=B * S + H, T=T)
    o_j, lse_j = jflash(q, k, v, causal=causal, interpret=True,
                        return_lse=True)
    o_t, lse_t = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, return_lse=True)
    assert lse_t.shape == (B, S, H) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=TOL,
                               atol=TOL)
    # what the model calls: the reference's mha in interpret mode
    m_j = jmha(q, k, v, causal, "interpret")
    m_t = tattn.mha(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=TOL,
                               atol=TOL)


def test_flash_attention_shape_contract():
    """S = 200 is not a multiple of the 128-row tile: both raise."""
    q, k, v = _qkv(1, 200, 2, 1, 64, seed=0)
    with pytest.raises(ValueError, match="must divide blocks"):
        jflash(q, k, v, interpret=True)
    with pytest.raises(ValueError, match="must divide blocks"):
        tattn.flash_attention(*map(torch.from_numpy, (q, k, v)))


BWD_TOL = 1e-4
BWD_SHAPES = _cases([
    (1, 128, 128, 2, 2, 64, True),      # MHA causal
    (2, 256, 256, 4, 2, 64, True),      # GQA (group-summed dk/dv)
    (1, 128, 128, 4, 4, 64, False),     # bidirectional
    (1, 384, 384, 2, 1, 64, True),      # MQA, 3 kv blocks
    (1, 128, 128, 2, 1, 192, True),     # Nemotron-4's dh, MQA
    (1, 128, 128, 4, 2, 192, False),    # Nemotron-4's dh, GQA bidirectional
    (2, 32, 64, 4, 4, 16, False),       # Whisper smoke's cross-attention
    (1, 128, 384, 4, 2, 64, False),     # cross, 3 kv blocks of 128
])


@pytest.mark.parametrize("B,S,T,H,K,dh,causal", BWD_SHAPES)
def test_flash_attention_bwd_matches_reference(B, S, T, H, K, dh, causal):
    q, k, v = _qkv(B, S, H, K, dh, seed=B * S + H, T=T)
    do = (np.random.default_rng(S).standard_normal((B, S, H, dh)) * 0.5) \
        .astype(np.float32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tattn.flash_attention(tq, tk, tv, causal, return_lse=True)
    got = tattn.flash_attention_bwd(tq, tk, tv, o, tdo, lse, causal)
    # the reference's entry: head-major [B*H, S, dh], K/V expanded to the
    # q heads; dk/dv group-summed afterwards (its ops.py:58-75)
    G = H // K

    def head_major(t):
        t = np.asarray(t)
        return t.transpose(0, 2, 1, 3).reshape(-1, t.shape[1], dh)

    dqh, dkh, dvh = jflash_bwd(
        head_major(q), head_major(np.repeat(k, G, axis=2)),
        head_major(np.repeat(v, G, axis=2)), head_major(o.numpy()),
        head_major(do), lse.numpy().transpose(0, 2, 1).reshape(-1, S),
        causal=causal, interpret=True)

    def back(t, n):
        return np.asarray(t).reshape(B, n, -1, dh).transpose(0, 2, 1, 3)

    want = (back(dqh, H), back(dkh, H).reshape(B, T, K, G, dh).sum(3),
            back(dvh, H).reshape(B, T, K, G, dh).sum(3))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=BWD_TOL, err_msg=name)


@pytest.mark.parametrize("B,S,T,H,K,dh,causal", BWD_SHAPES)
def test_mha_interpret_grads_match_reference(B, S, T, H, K, dh, causal):
    q, k, v = _qkv(B, S, H, K, dh, seed=B * S + H + 1, T=T)
    ct = (np.random.default_rng(S + 1).standard_normal((B, S, H, dh))
          * 0.5).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jmha(*a, causal, "interpret") * jnp.asarray(ct)),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = tattn.mha(*leaves, causal, "interpret")
    assert type(out.grad_fn).__name__ == "_FlashMHABackward"
    out.backward(torch.from_numpy(ct))
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=BWD_TOL, err_msg=name)
    # mode=None on the CPU is the oracle differentiated by autograd
    assert tattn.mha(*leaves, causal).grad_fn is not None
    assert type(tattn.mha(*leaves, causal).grad_fn).__name__ \
        != "_FlashMHABackward"


def test_flash_attention_bwd_shape_contract():
    """S = 200 is not a multiple of the 128-row tile: both backwards
    raise."""
    q, k, v = _qkv(1, 200, 2, 1, 64, seed=0)
    qh = q.transpose(0, 2, 1, 3).reshape(-1, 200, 64)
    kh = k.transpose(0, 2, 1, 3).reshape(-1, 200, 64)
    lse = np.zeros((2, 200), np.float32)
    with pytest.raises(ValueError, match="must divide"):
        jflash_bwd(qh, kh, kh, qh, qh, lse, interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="must divide blocks"):
        tattn.flash_attention_bwd(tq, tk, tv, tq, tq,
                                  torch.zeros((1, 200, 2)))


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    a = -np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    return xdt, a, b, c


def test_ssd_intra_matches_reference():
    BC, Q, H, P, N = 3, 16, 8, 16, 32
    xdt, a, b, c = _ssd_inputs(BC, Q, H, P, N, seed=4)
    got = tssd.ssd_intra(*map(torch.from_numpy, (xdt, a, b, c)))
    want = jssd_intra(xdt, a, b, c, interpret=True)
    for name, g, w in zip(("y", "state", "cum"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SSD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_reference(with_h0):
    B, S, H, P, N, Q = 2, 32, 8, 16, 32, 16
    xdt, a, b, c = _ssd_inputs(B, S, H, P, N, seed=5)
    h0 = None
    if with_h0:
        h0 = (np.random.default_rng(6).standard_normal((B, H, P, N)) * 0.5) \
            .astype(np.float32)
    y_j, h_j = jssd_scan(xdt, a, b, c, chunk=Q, mode="interpret",
                         h0=None if h0 is None else jnp.asarray(h0))
    y_t, h_t = tssd.ssd_scan(*map(torch.from_numpy, (xdt, a, b, c)),
                             chunk=Q,
                             h0=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=SSD_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=SSD_TOL)


def test_flash_route_is_a_rule_of_dtype_and_dh():
    """bf16 with dh a multiple of 16 up to 192 (Nemotron-4's head) takes
    the tensor-core kernels, dq's and dk/dv's both; fp32, and bf16 with
    any other dh, the FMA kernels."""
    route = tattn.tensor_core_route
    assert all(route(torch.bfloat16, dh)
               for dh in (16, 64, 80, 128, 144, 192))
    assert not any(route(torch.bfloat16, dh)
                   for dh in (8, 72, 100, 200, 208, 256))
    assert not any(route(torch.float32, dh) for dh in (64, 128, 192))
    tc = (tattn.FLASH_BWD_DQ_TC, tattn.FLASH_BWD_DKV_TC)
    fma = (tattn.FLASH_BWD_DQ, tattn.FLASH_BWD_DKV)
    assert tattn.bwd_kernels(torch.bfloat16, 128) == tc
    assert tattn.bwd_kernels(torch.bfloat16, 192) == tc
    assert tattn.bwd_kernels(torch.bfloat16, 72) == fma
    assert tattn.bwd_kernels(torch.bfloat16, 208) == fma
    assert tattn.bwd_kernels(torch.float32, 128) == fma
    assert tattn.FLASH_BWD_DQ_TC.symbol == "flash_attention_bwd_dq_tc"
    assert tattn.FLASH_BWD_DQ_TC.library is tattn.FLASH_BWD_DKV_TC.library


def test_build_cache_key_covers_headers_and_flags(tmp_path, monkeypatch):
    """A library's cached ``.so`` is named by its source, the ``*.cuh``
    headers beside it and in the shared include directory, and the flags
    (an ``-I`` path, say): editing any of them names a new library, so a
    stale one is never loaded.  Every build gets ``-I`` to the shared
    directory, which holds ``sm90.cuh``."""
    from repro_torch.kernels import _build
    assert (_build.INCLUDE_DIR / "sm90.cuh").exists()
    declared = len(_build._LIBRARIES)
    shared = tmp_path / "shared"
    shared.mkdir()
    (shared / "s.cuh").write_text("// shared one\n")
    monkeypatch.setattr(_build, "INCLUDE_DIR", shared)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")   # none here
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    (tmp_path / "notes.txt").write_text("not a header\n")
    lib = _build.Library("probe", tmp_path / "k.cu")
    try:
        command = lib._command(tmp_path / "out.so")
        assert command[command.index("-I") + 1] == str(shared)
        first = lib.path
        assert first == _build.Library("probe", tmp_path / "k.cu").path
        (shared / "s.cuh").write_text("// shared two\n")
        assert lib.path != first
        first = lib.path
        (tmp_path / "notes.txt").write_text("edited\n")
        assert lib.path == first
        (tmp_path / "h.cuh").write_text("// two\n")
        header = lib.path
        assert header != first
        (tmp_path / "g.cuh").write_text("// new header\n")
        assert lib.path != header
        (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
        assert lib.path not in (first, header)
        before = lib.path
        monkeypatch.setattr(_build, "NVCC_FLAGS",
                            _build.NVCC_FLAGS + ("-I", str(tmp_path)))
        assert lib.path != before
    finally:
        del _build._LIBRARIES[declared:]


def test_lm_wrappers_never_fall_back():
    """A tensor on neither the CPU nor a card has no kernel and no plain
    path: the wrappers raise instead of computing elsewhere, and launch
    nothing."""
    kernels = (tattn.FLASH, tattn.FLASH_TC, tattn.FLASH_BWD_DQ,
               tattn.FLASH_BWD_DQ_TC, tattn.FLASH_BWD_DKV,
               tattn.FLASH_BWD_DKV_TC, tssd.SSD_INTRA)
    counts = [kern.launches for kern in kernels]
    q = torch.zeros((1, 128, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tattn.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        tattn.flash_attention_bwd(q, q, q, q, q,
                                  torch.zeros((1, 128, 2), device="meta"))
    x = torch.zeros((2, 16, 2, 16), device="meta")
    a = torch.zeros((2, 16, 2), device="meta")
    bc = torch.zeros((2, 16, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tssd.ssd_intra(x, a, bc, bc)
    assert [kern.launches for kern in kernels] == counts
