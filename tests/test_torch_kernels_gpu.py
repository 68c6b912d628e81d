"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Needs a CUDA device and ``nvcc`` (each test skips without a card; the
check happens inside the fixture).  Imports no JAX, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

probe, sample, gather and the sharded gather must agree exactly (and the
shards' results of the sharded gather sum to the whole gather); the
QuadConv contraction
within fp32 rounding (1e-5 relative to the output's magnitude), bit for
bit between batch sizes (its summation order does not depend on B) and
on a rerun, at shapes that reach each branch of its split plan; given w
with any one of the plan's chunks of i zeroed it must miss that limit.
The contraction's autograd Function with the kernel forward gives the
same gradients as with ``mode="ref"`` (its backward is the same einsums
either way) and an output within the forward's tolerance.

The flash-attention forward is held to its plain version (fp32 math on
the same inputs) within 2e-5 in fp32 (output and log-sum-exp).  In bf16
its output is held, as the plain version's is, to the exact value (fp64
math on the same inputs) within one bf16 rounding of the output's
magnitude (2^-8 of max|o|), and its fp32 log-sum-exp to the plain
version's within 1e-4.  (Two fp32 sums in different orders can round an
output that lies near a bf16 midpoint to its two sides, a whole bf16 ulp
apart, which in the top binade of |o| is more than 2^-8 max|o|: the
exact value is the one both are a rounding of.)  At G = 3, at S equal to
one tile, at S below a tile, without the causal mask, and at the LM zoo's
head layouts (G = 16, 5, 9, 7; LLaVA's S = 3,200).  The SSD intra-chunk
kernel is held to its plain version within 1e-4 of each output's
magnitude (3e-5 for ``cum``, a 256-term fp32 prefix sum taken in another
order), with decays large enough that the masked entries above the
diagonal overflow: a mask applied after the exp would show as NaN, and
with head counts that leave the kernel's last group of four heads short,
and at Jamba's smoke prefill (chunks of 16);
given ``a`` with two heads swapped it must miss y's limit.

The flash-attention backward kernels (dq; dk/dv) are held to their plain
version on the forward kernel's own o and LSE, on the reference's four
sweep shapes, Phi-4-mini's head layout (H = 24, K = 8, dh = 128),
Nemotron-4's dh = 192 (and its training shape), dh = 160 and the FMA
kernels' widest dh = 256: fp32
within 2e-5 of each output's magnitude, bf16 within 2^-8 of it; the bf16
ones run on the tensor cores, each bit-identical on a rerun and missing
its limit with the causal mask off; ``mha``
differentiated through the kernels agrees with autograd through
``mha_ref`` within the reference's 1e-4.

The clustered deployment's overlapped capture, its copies on a staging
stream, leaves the serial capture's table bit for bit.

``train.checkpoint.Checkpointer`` stages a state on the card into pinned
host memory: a save raises ``max_memory_allocated`` by no more than the
largest leaf, an in-place update queued right after it never reaches
the files, and an in-place ``restore`` leaves the peak level and brings
every leaf back bit for bit.
"""

import pytest


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, qops, qref, sops, sref, aops, aref, dops, dref
    import torch
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.kernels.attention import ref as aref
    from repro_torch.kernels.ssd import ops as dops
    from repro_torch.kernels.ssd import ref as dref
    from repro_torch.kernels.quadconv import ops as qops
    from repro_torch.kernels.quadconv import ref as qref
    from repro_torch.kernels.store import ops as sops
    from repro_torch.kernels.store import ref as sref


pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("capacity,n", [(32, 8), (100, 50), (7, 1)])
def test_probe_kernel_exact(cuda, capacity, n):
    gen = torch.Generator().manual_seed(capacity)
    keys = torch.randint(0, 9, (capacity,), generator=gen,
                         dtype=torch.int64)
    keys[::5] = sref.EMPTY_KEY
    version = torch.randint(0, 3, (capacity,), generator=gen,
                            dtype=torch.int32)
    query = torch.randint(0, 11, (n,), generator=gen, dtype=torch.int64)
    query[0] = sref.EMPTY_KEY
    args = [t.to(cuda) for t in (keys, version, query)]
    launches = sops.PROBE.launches
    idx, found = sops.probe_slots(*args)
    want_idx, want_found = sref.probe_slots_ref(*args)
    torch.cuda.synchronize()
    assert sops.PROBE.launches == launches + 1
    assert torch.equal(idx, want_idx) and torch.equal(found, want_found)


@pytest.mark.parametrize("capacity,n,live", [(24, 6, 0.7), (4096, 256, 0.5),
                                             (1000, 37, 0.9), (300, 9, 0.0),
                                             (1, 4, 1.0)])
def test_sample_kernel_exact(cuda, capacity, n, live):
    """Dead slots, an empty table (live 0), and ranks from -2 to past the
    live count, against the plain version."""
    gen = torch.Generator().manual_seed(capacity)
    version = torch.randint(1, 100, (capacity,), generator=gen,
                            dtype=torch.int32)
    version[torch.rand(capacity, generator=gen) >= live] = 0
    nvalid = int((version > 0).sum())
    ranks = torch.randint(-2, nvalid + 3, (n,), generator=gen,
                          dtype=torch.int32)
    version, ranks = version.to(cuda), ranks.to(cuda)
    launches = sops.SAMPLE.launches
    slots = sops.sample_slots(version, ranks)
    want = sref.sample_slots_ref(version, ranks)
    torch.cuda.synchronize()
    assert sops.SAMPLE.launches == launches + 1
    assert torch.equal(slots, want)


@pytest.mark.parametrize("B,I,C,J,O", [(4, 512, 4, 128, 16),
                                       (1, 96, 16, 40, 16)])
def test_quadconv_grads_with_kernel_forward(cuda, B, I, C, J, O):
    gen = torch.Generator(device=cuda).manual_seed(3)
    f = torch.randn((B, I, C), generator=gen, device=cuda)
    w = torch.rand((I,), generator=gen, device=cuda) / I
    g = torch.randn((J, I, O, C), generator=gen, device=cuda)
    ct = torch.randn((B, J, O), generator=gen, device=cuda)
    grads, outs = {}, {}
    for mode in (None, "ref"):
        leaves = [t.clone().requires_grad_(True) for t in (f, w, g)]
        outs[mode] = qops.quadconv_contract(*leaves, mode)
        outs[mode].backward(ct)
        grads[mode] = [t.grad for t in leaves]
    tol = 1e-5 * float(outs["ref"].detach().abs().max())
    assert float((outs[None] - outs["ref"]).abs().max()) <= tol
    for got, want in zip(grads[None], grads["ref"]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,elem", [("float32", (4, 4096)),
                                        ("int16", (3,))],
                         ids=["dtype0-elem0", "dtype1-elem1"])
def test_gather_kernel_exact(cuda, dtype, elem):
    gen = torch.Generator().manual_seed(1)
    slab = (torch.randn((32, *elem), generator=gen) * 100).to(
        getattr(torch, dtype))
    slots = torch.randint(0, 32, (9,), generator=gen, dtype=torch.int32)
    slab, slots = slab.to(cuda), slots.to(cuda)
    out = sops.gather_rows(slab, slots)
    assert torch.equal(out, sref.gather_rows_ref(slab, slots))


def test_gather_kernel_exact_on_a_colocated_shard(cuda):
    """The gather on one rank's shard of a co-located ring: rows of the
    [2, 2048, 4096] fp32 block a 4,096^2 FD snapshot puts on each of 2
    space ranks (32 MB a row), a separate allocation per rank."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    shard = torch.randn((4, 2, 2048, 4096), generator=gen, device=cuda)
    slots = torch.tensor([3, 0, 2, 3], dtype=torch.int32, device=cuda)
    out = sops.gather_rows(shard, slots)
    assert torch.equal(out, sref.gather_rows_ref(shard, slots))


@pytest.mark.parametrize("elem", [
    (4, 2048),     # the training table's rows: 2 of a block's 1,024 units
    (4, 1000),     # 1,000 16-byte units: no multiple of the block's 1,024
    (3,),          # 12 bytes: the byte-copy path
])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_gather_sharded_kernel_exact(cuda, D, elem):
    gen = torch.Generator().manual_seed(D)
    capacity = 24
    cl = capacity // D
    slab = torch.randn((capacity, *elem), generator=gen).to(cuda)
    slab[3] = -0.0                                   # the psum's -0.0 case
    edges = [s for r in range(D) for s in (r * cl, r * cl + cl - 1)]
    slots = torch.tensor(edges + [5, 17, 3], dtype=torch.int32).to(cuda)
    total = None
    for r in range(D):
        local = slab[r * cl:(r + 1) * cl]
        launches = sops.GATHER_SHARDED.launches
        out = sops.gather_rows_sharded(local, slots, r * cl)
        assert sops.GATHER_SHARDED.launches == launches + 1
        want = sref.gather_rows_sharded_ref(local, slots, r * cl)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
        total = out if total is None else total + out
    torch.cuda.synchronize()
    assert torch.equal(total, sops.gather_rows(slab, slots))


def test_gather_sharded_kernel_refuses_what_it_does_not_take(cuda):
    slab = torch.randn((8, 4, 16), device=cuda)
    slots = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tensors on"):
        sops.gather_rows_sharded(slab, slots.cpu(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        sops.gather_rows_sharded(slab[:, :, ::2], slots, 0)
    with pytest.raises(TypeError, match="int32"):
        sops.gather_rows_sharded(slab, slots.long(), 0)


def _quadconv_inputs(cuda, B, I, C, J, O):
    gen = torch.Generator(device=cuda).manual_seed(2)
    f = torch.randn((B, I, C), generator=gen, device=cuda)
    w = torch.rand((I,), generator=gen, device=cuda) / I
    g = torch.randn((J, I, O, C), generator=gen, device=cuda)
    return f, w, g


def _quadconv_plan(cuda, I, C, J, O):
    return qops._split_plan(I, J, O, C, qops._sm_count(qops._index(cuda)))


@pytest.mark.parametrize("B,I,C,J,O", [
    (8, 4096, 4, 64, 16),      # encoder block 0 (J cut: the kernel's j
    (8, 1024, 16, 64, 16),     # tiles are independent), block 1
    (3, 40, 4, 10, 16),        # ragged tile and j-group tails
    (11, 70, 16, 5, 16),       # more batch rows than one block holds
    (2, 16, 8, 9, 2),
    (4, 512, 16, 512, 16),     # encoder 1 / decoder 0 in training, whole
    (2, 2048, 4, 2048, 16),    # encoder 0 at a mesh rank's B = 2, whole
    (5, 1000, 16, 64, 16),     # I that no chunk length divides
    (3, 530, 4, 3, 16),        # J below one j tile; a 2-row last stage
])
def test_quadconv_kernel_close(cuda, B, I, C, J, O):
    f, w, g = _quadconv_inputs(cuda, B, I, C, J, O)
    out = qops.quadconv_contract(f, w, g)
    want = qref.quadconv_contract_ref(f, w, g)
    tol = 1e-5 * float(want.abs().max())
    assert float((out - want).abs().max()) <= tol
    # a row's bits do not depend on the batch it rides in
    for b in range(B):
        one = qops.quadconv_contract(f[b:b + 1].contiguous(), w, g)
        assert torch.equal(one[0], out[b])


@pytest.mark.parametrize("B,I,C,J,O", [
    (4, 512, 16, 512, 16),     # training, two chunks
    (8, 4096, 4, 64, 16),      # serving block 0 (J cut), sixteen chunks
])
def test_quadconv_kernel_bit_identical_rerun(cuda, B, I, C, J, O):
    f, w, g = _quadconv_inputs(cuda, B, I, C, J, O)
    launches = qops.QUADCONV.launches
    first = qops.quadconv_contract(f, w, g)
    second = qops.quadconv_contract(f, w, g)
    torch.cuda.synchronize()
    assert qops.QUADCONV.launches == launches + 2
    assert _quadconv_plan(cuda, I, C, J, O).splits > 1
    assert torch.equal(first, second)


def test_quadconv_kernel_dropped_chunk_fails(cuda):
    """The control: w with any one chunk of the plan zeroed misses the
    1e-5 limit against the plain version of the unmodified inputs, so the
    limit would catch a chunk the kernel dropped."""
    B, I, C, J, O = 5, 1000, 16, 64, 16
    f, w, g = _quadconv_inputs(cuda, B, I, C, J, O)
    want = qref.quadconv_contract_ref(f, w, g)
    tol = 1e-5 * float(want.abs().max())
    chunks = _quadconv_plan(cuda, I, C, J, O).chunks()
    assert len(chunks) > 1 and I % (chunks[0][1] - chunks[0][0])
    for i0, i1 in chunks:
        dropped = w.clone()
        dropped[i0:i1] = 0
        out = qops.quadconv_contract(f, dropped, g)
        assert float((out - want).abs().max()) > tol, (i0, i1)


def test_quadconv_kernel_refuses_what_it_does_not_take(cuda):
    f = torch.zeros((1, 8, 3), device=cuda)
    with pytest.raises(ValueError, match="C % 4"):
        qops.quadconv_contract(f, torch.zeros(8, device=cuda),
                               torch.zeros((4, 8, 2, 3), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        qops.quadconv_contract(f.double()[..., :2].repeat(1, 1, 2),
                               torch.zeros(8, device=cuda, dtype=torch.double),
                               torch.zeros((4, 8, 4, 4), device=cuda,
                                           dtype=torch.double))


def _counts(*kernels) -> list:
    return [kern.launches for kern in kernels]


def _qkv(cuda, shape, seed, n=3, dtype="bfloat16"):
    B, S, H, K, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shapes = ((B, S, H, dh), (B, S, K, dh), (B, S, K, dh), (B, S, H, dh))
    return [torch.randn(s, generator=gen, device=cuda).mul(0.5)
            .to(getattr(torch, dtype)) for s in shapes[:n]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,dh,causal", [
    (2, 256, 6, 2, 128, True),      # G = 3 (Phi-4-mini's), dh 128
    (1, 128, 3, 1, 64, True),       # S = one tile of the reference
    (2, 48, 4, 2, 64, True),        # S below a tile: a ragged kernel tile
    (1, 256, 4, 4, 64, False),      # no causal mask
    (1, 256, 12, 1, 192, True),     # Nemotron-4's dh and G = 12
    (1, 128, 4, 4, 160, False),     # dh 160: the 192 instance, padded
    (1, 128, 2, 1, 256, True),      # the FMA kernel's widest dh
])
def test_flash_kernel_close(cuda, dtype, B, S, H, K, dh, causal):
    """fp32 runs the FMA kernel, bf16 (dh 64, 128, 160, 192) the
    tensor-core one and bf16 at dh 256 the FMA one."""
    gen = torch.Generator(device=cuda).manual_seed(S + H)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).mul(0.5).to(dt)
               for shape in ((B, S, H, dh), (B, S, K, dh), (B, S, K, dh)))
    launches = _counts(aops.FLASH, aops.FLASH_TC)
    o, lse = aops.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    tc = aops.tensor_core_route(dt, dh)
    assert _counts(aops.FLASH, aops.FLASH_TC) == [
        launches[0] + (not tc), launches[1] + tc]
    assert o.dtype == dt and lse.dtype == torch.float32
    if dtype == "bfloat16":
        err, tol, lse_err = _fwd_errors(q, k, v, o, lse, causal)
        assert err <= tol and lse_err <= 1e-4, (err, tol, lse_err)
    else:
        o_r, lse_r = aref.flash_attention_ref(q, k, v, causal)
        assert float((o - o_r).abs().max()) <= 2e-5
        assert float((lse - lse_r).abs().max()) <= 2e-5
    # mha, the model's entry, is the same launch
    assert torch.equal(aops.mha(q, k, v, causal), o)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    """The forward and both backward kernels refuse a sequence that is not
    a multiple of the tile, fp16, dh past 256 and a strided last axis."""
    q = torch.zeros((1, 200, 2, 64), device=cuda)
    lse = torch.zeros((1, 200, 2), device=cuda)
    with pytest.raises(ValueError, match="must divide blocks"):
        aops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="must divide blocks"):
        aops.flash_attention_bwd(q, q, q, q, q, lse)
    with pytest.raises(TypeError, match="bfloat16"):
        aops.flash_attention(*(torch.zeros((1, 128, 2, 64), device=cuda,
                                           dtype=torch.float16),) * 3)
    half = torch.zeros((1, 128, 2, 64), device=cuda, dtype=torch.float16)
    lse = torch.zeros((1, 128, 2), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        aops.flash_attention_bwd(half, half, half, half, half, lse)
    wide = torch.zeros((1, 128, 2, 260), device=cuda)
    with pytest.raises(ValueError, match="<= 256"):
        aops.flash_attention_bwd(wide, wide, wide, wide, wide, lse)
    with pytest.raises(ValueError, match="<= 256"):
        aops.flash_attention(wide, wide, wide)
    q = torch.zeros((1, 128, 2, 64), device=cuda)
    strided = torch.zeros((1, 128, 64, 2), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        aops.flash_attention_bwd(q, q, q, q, strided, lse)
    with pytest.raises(ValueError, match="contiguous"):
        aops.flash_attention(strided, q, q)


BWD_SHAPES = [
    (1, 128, 2, 2, 64, True),       # MHA causal       (the reference's
    (2, 256, 4, 2, 64, True),       # GQA               test_kernels.py
    (1, 128, 4, 4, 64, False),      # bidirectional     sweep)
    (1, 384, 2, 1, 64, True),       # MQA, 3 kv blocks
    (1, 256, 24, 8, 128, True),     # Phi-4-mini's heads: G = 3, dh 128
    (1, 256, 12, 1, 192, True),     # Nemotron-4's dh and G = 12
    (1, 128, 4, 4, 160, False),     # dh 160: the 192 instance, padded
    (1, 128, 2, 1, 256, True),      # the FMA kernels' widest dh
    (2, 48, 4, 2, 192, True),       # dh 192, a ragged 48-row tile
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,dh,causal", BWD_SHAPES)
def test_flash_bwd_kernels_close(cuda, dtype, B, S, H, K, dh, causal):
    """dq and dk/dv against the plain version on the forward kernel's own
    o and LSE: fp32 within 2e-5 of each output's magnitude (sums in
    another order), bf16 within one bf16 rounding of it (2^-8)."""
    gen = torch.Generator(device=cuda).manual_seed(S + H + 1)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda).mul(0.5)
                   .to(dt) for shape in ((B, S, H, dh), (B, S, K, dh),
                                         (B, S, K, dh), (B, S, H, dh)))
    o, lse = aops.flash_attention(q, k, v, causal, return_lse=True)
    kernels = (aops.FLASH_BWD_DQ, aops.FLASH_BWD_DQ_TC, aops.FLASH_BWD_DKV,
               aops.FLASH_BWD_DKV_TC)
    counts = _counts(*kernels)
    got = aops.flash_attention_bwd(q, k, v, o, do, lse, causal)
    want = aref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    tc = aops.tensor_core_route(dt, dh)   # dq and dk/dv on the tensor cores
    assert _counts(*kernels) == [counts[0] + (not tc), counts[1] + tc,
                                 counts[2] + (not tc), counts[3] + tc]
    rel = 2e-5 if dtype == "float32" else 2.0 ** -8
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * float(w.float().abs().max()), (name, err)


def _exact_o(q, k, v, causal):
    """The attention output in fp64 from the same inputs, unrounded."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    logits = torch.einsum("bskgd,btkd->bkgst",
                          q.double().reshape(B, S, K, H // K, dh),
                          k.double()) / dh ** 0.5
    if causal:                              # top-left: qpos >= kpos
        logits.masked_fill_(torch.ones((S, T), dtype=torch.bool,
                                       device=q.device).triu(1),
                            float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.double()).reshape(
        B, S, H, dh)


def _fwd_errors(q, k, v, o, lse, causal):
    """(o error, o limit, LSE error) of a bf16 forward: o against the
    exact value, whose one bf16 rounding of max|o| is the limit (the plain
    version's o must meet it too); the LSE against the plain version's."""
    o_r, lse_r = aref.flash_attention_ref(q, k, v, causal)
    exact = _exact_o(q, k, v, causal)
    tol = 2.0 ** -8 * float(exact.abs().max())
    plain_err = float((o_r.double() - exact).abs().max())
    assert plain_err <= tol, ("plain version", plain_err, tol)
    return (float((o.double() - exact).abs().max()), tol,
            float((lse - lse_r).abs().max()))


def _bwd_errors(got, want):
    """dq, dk and dv's errors over their bf16 limits (2^-8 of the max)."""
    return [float((g.float() - w.float()).abs().max())
            / (2.0 ** -8 * float(w.float().abs().max()))
            for g, w in zip(got, want)]


PHI4_TRAIN = (1, 2048, 24, 8, 128)   # one micro-batch of the training cell


def test_flash_tc_kernels_at_the_phi4_training_shape(cuda):
    """bf16 at Phi-4-mini's training shape runs the tensor-core forward,
    dq and dk/dv, one launch each and none of the FMA kernels, within the
    bf16 limits."""
    q, k, v, do = _qkv(cuda, PHI4_TRAIN, seed=7, n=4)
    kernels = (aops.FLASH, aops.FLASH_TC, aops.FLASH_BWD_DQ,
               aops.FLASH_BWD_DQ_TC, aops.FLASH_BWD_DKV,
               aops.FLASH_BWD_DKV_TC)
    counts = _counts(*kernels)
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    got = aops.flash_attention_bwd(q, k, v, o, do, lse, True)
    torch.cuda.synchronize()
    assert _counts(*kernels) == [counts[0], counts[1] + 1, counts[2],
                                 counts[3] + 1, counts[4], counts[5] + 1]
    err, tol, lse_err = _fwd_errors(q, k, v, o, lse, True)
    assert err <= tol and lse_err <= 1e-4, (err, tol, lse_err)
    want = aref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    assert max(_bwd_errors(got, want)) <= 1.0


NEMOTRON_TRAIN = (1, 2048, 96, 8, 192)   # Nemotron-4's micro-batch


def test_flash_tc_kernels_at_the_nemotron_training_shape(cuda):
    """bf16 at Nemotron-4's training shape (dh 192, G = 12) runs the
    tensor-core forward, dq and dk/dv, one launch each and none of the
    FMA kernels, within the bf16 limits; dq, dk and dv are bit-identical
    on a rerun."""
    q, k, v, do = _qkv(cuda, NEMOTRON_TRAIN, seed=7, n=4)
    kernels = (aops.FLASH, aops.FLASH_TC, aops.FLASH_BWD_DQ,
               aops.FLASH_BWD_DQ_TC, aops.FLASH_BWD_DKV,
               aops.FLASH_BWD_DKV_TC)
    counts = _counts(*kernels)
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    got = aops.flash_attention_bwd(q, k, v, o, do, lse, True)
    torch.cuda.synchronize()
    assert _counts(*kernels) == [counts[0], counts[1] + 1, counts[2],
                                 counts[3] + 1, counts[4], counts[5] + 1]
    err, tol, lse_err = _fwd_errors(q, k, v, o, lse, True)
    assert err <= tol and lse_err <= 1e-4, (err, tol, lse_err)
    want = aref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    assert max(_bwd_errors(got, want)) <= 1.0
    again = aops.flash_attention_bwd(q, k, v, o, do, lse, True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_tc_mask_off_control_fails_at_dh_192(cuda):
    """The dh = 192 instances' limits can fail: the tensor-core kernels
    with the causal mask off miss them."""
    q, k, v, do = _qkv(cuda, (1, 256, 12, 1, 192), seed=9, n=4)
    o, lse = aops.flash_attention(q, k, v, False, return_lse=True)
    err, tol, lse_err = _fwd_errors(q, k, v, o, lse, True)
    assert err > tol and lse_err > 1e-4
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    got = aops.flash_attention_bwd(q, k, v, o, do, lse, False)
    want = aref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    assert min(_bwd_errors(got, want)) > 1.0


def test_flash_bf16_past_the_tensor_core_route(cuda):
    """bf16 at dh 208, a multiple of 16 past the tensor-core kernels'
    192, takes the FMA kernels (their wide instances), by the route rule
    alone."""
    q, k, v, do = _qkv(cuda, (1, 128, 4, 2, 208), seed=11, n=4)
    kernels = (aops.FLASH, aops.FLASH_TC, aops.FLASH_BWD_DQ,
               aops.FLASH_BWD_DQ_TC, aops.FLASH_BWD_DKV,
               aops.FLASH_BWD_DKV_TC)
    counts = _counts(*kernels)
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    got = aops.flash_attention_bwd(q, k, v, o, do, lse, True)
    torch.cuda.synchronize()
    assert _counts(*kernels) == [counts[0] + 1, counts[1], counts[2] + 1,
                                 counts[3], counts[4] + 1, counts[5]]
    err, tol, _ = _fwd_errors(q, k, v, o, lse, True)
    assert err <= tol
    want = aref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    assert max(_bwd_errors(got, want)) <= 1.0


# the LM zoo's head layouts (H, K, dh 128), at B = 1 and S = 1,024, and
# LLaVA's prefill length (1,152 patches + 2,048 tokens = 25 tiles of 128)
ZOO_LAYOUTS = {"qwen3_moe": (1, 1024, 64, 4, 128),
               "llama4_scout": (1, 1024, 40, 8, 128),
               "starcoder2_7b": (1, 1024, 36, 4, 128),
               "llava": (1, 3200, 56, 8, 128)}


@pytest.mark.parametrize("model", sorted(ZOO_LAYOUTS))
def test_flash_tc_forward_at_the_zoo_head_layouts(cuda, model):
    """bf16 at each new family's head layout (G = 16, 5, 9, 7 query heads
    a kv head) runs the tensor-core forward, one launch and none of the
    FMA one, within the bf16 limits."""
    q, k, v = _qkv(cuda, ZOO_LAYOUTS[model], seed=5)
    counts = _counts(aops.FLASH, aops.FLASH_TC)
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    torch.cuda.synchronize()
    assert _counts(aops.FLASH, aops.FLASH_TC) == [counts[0], counts[1] + 1]
    err, tol, lse_err = _fwd_errors(q, k, v, o, lse, True)
    assert err <= tol and lse_err <= 1e-4, (err, tol, lse_err)


@pytest.mark.parametrize("shape", [(2, 256, 6, 2, 128), (2, 48, 4, 2, 64),
                                   (2, 48, 4, 2, 192)])
def test_flash_tc_forward_warpgroups(cuda, shape):
    """The tensor-core forward's block of two consumer warpgroups (128 q
    rows) meets the limits on whole blocks and where the second
    warpgroup has no rows (S = 48, a ragged tile; at dh 64 and 192)."""
    q, k, v = _qkv(cuda, shape, seed=2)
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    err, tol, lse_err = _fwd_errors(q, k, v, o, lse, True)
    assert err <= tol and lse_err <= 1e-4, (err, tol, lse_err)


def test_flash_bwd_dkv_tc_is_deterministic(cuda):
    """No atomics: each (b, kv head, kv tile) has one owner, so two runs
    of dk/dv on the same inputs are bit-identical."""
    q, k, v, do = _qkv(cuda, PHI4_TRAIN, seed=8, n=4)
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    first = aops.flash_attention_bwd(q, k, v, o, do, lse, True)
    again = aops.flash_attention_bwd(q, k, v, o, do, lse, True)
    assert torch.equal(first[1], again[1]) and torch.equal(first[2],
                                                           again[2])


def test_flash_bwd_dq_tc_is_deterministic(cuda):
    """No atomics: each (b, query head, q tile) of dq has one owner, so
    two runs on the same inputs are bit-identical."""
    q, k, v, do = _qkv(cuda, PHI4_TRAIN, seed=8, n=4)
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    launches = aops.FLASH_BWD_DQ_TC.launches
    first = aops.flash_attention_bwd(q, k, v, o, do, lse, True)
    again = aops.flash_attention_bwd(q, k, v, o, do, lse, True)
    assert aops.FLASH_BWD_DQ_TC.launches == launches + 2
    assert torch.equal(first[0], again[0])


def test_flash_tc_mask_off_control_fails(cuda):
    """The limits can fail: the tensor-core kernels with the causal mask
    off, held to the causal exact value and plain version, miss them."""
    q, k, v, do = _qkv(cuda, (2, 256, 6, 2, 128), seed=9, n=4)
    o, lse = aops.flash_attention(q, k, v, False, return_lse=True)
    err, tol, lse_err = _fwd_errors(q, k, v, o, lse, True)
    assert err > tol and lse_err > 1e-4
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    got = aops.flash_attention_bwd(q, k, v, o, do, lse, False)
    want = aref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    assert min(_bwd_errors(got, want)) > 1.0


def test_flash_bf16_off_the_tensor_core_route(cuda):
    """bf16 with dh not a multiple of 16 takes the FMA kernels, by the
    route rule alone."""
    q, k, v, do = _qkv(cuda, (1, 128, 4, 2, 72), seed=10, n=4)
    kernels = (aops.FLASH, aops.FLASH_TC, aops.FLASH_BWD_DQ,
               aops.FLASH_BWD_DQ_TC, aops.FLASH_BWD_DKV,
               aops.FLASH_BWD_DKV_TC)
    counts = _counts(*kernels)
    o, lse = aops.flash_attention(q, k, v, True, return_lse=True)
    aops.flash_attention_bwd(q, k, v, o, do, lse, True)
    torch.cuda.synchronize()
    assert _counts(*kernels) == [counts[0] + 1, counts[1], counts[2] + 1,
                                 counts[3], counts[4] + 1, counts[5]]
    err, tol, _ = _fwd_errors(q, k, v, o, lse, True)
    assert err <= tol


def test_mha_autograd_through_the_kernels(cuda):
    """``mha`` on the card differentiates through the three kernels (one
    launch each) and agrees with autograd through ``mha_ref`` within the
    reference's own 1e-4 (``test_kernels.py``), with a cotangent whose
    last axis is strided."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, S, H, K, dh = 2, 256, 6, 2, 64
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).mul(0.5)
               for shape in ((B, S, H, dh), (B, S, K, dh), (B, S, K, dh)))
    ct = torch.randn((B, S, dh, H), generator=gen, device=cuda).mul(0.5) \
        .transpose(2, 3)
    assert ct.stride(3) != 1
    grads = {}
    for mode in (None, "ref"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        counts = [kern.launches for kern in (aops.FLASH, aops.FLASH_BWD_DQ,
                                             aops.FLASH_BWD_DKV)]
        aops.mha(*leaves, True, mode).backward(ct)
        torch.cuda.synchronize()
        grown = [kern.launches - c for kern, c in zip(
            (aops.FLASH, aops.FLASH_BWD_DQ, aops.FLASH_BWD_DKV), counts)]
        assert grown == ([1, 1, 1] if mode is None else [0, 0, 0])
        grads[mode] = [t.grad for t in leaves]
    for got, want in zip(grads[None], grads["ref"]):
        assert float((got - want).abs().max()) <= 1e-4


def test_ssd_kernel_refuses_a_gradient(cuda):
    """Neither package has an SSD backward kernel: asking the CUDA kernel
    for a gradient raises (training takes ``ssd_impl="xla"``)."""
    xdt = torch.zeros((2, 16, 2, 16), device=cuda, requires_grad=True)
    a = torch.zeros((2, 16, 2), device=cuda)
    bc = torch.zeros((2, 16, 8), device=cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        dops.ssd_intra(xdt, a, bc, bc)
    with torch.no_grad():
        dops.ssd_intra(xdt, a, bc, bc)


def _ssd_inputs(cuda, BC, Q, H, P, N, decay):
    gen = torch.Generator(device=cuda).manual_seed(Q + H)
    xdt = torch.randn((BC, Q, H, P), generator=gen, device=cuda) * 0.5
    a = -torch.nn.functional.softplus(
        torch.randn((BC, Q, H), generator=gen, device=cuda)) * decay
    b = torch.randn((BC, Q, N), generator=gen, device=cuda) * 0.5
    c = torch.randn((BC, Q, N), generator=gen, device=cuda) * 0.5
    return xdt, a, b, c


@pytest.mark.parametrize("BC,Q,H,P,N,decay", [
    (4, 256, 8, 64, 128, 1.0),      # Mamba-2's chunk, state and head width
    (3, 100, 5, 16, 40, 1.0),       # ragged tiles in Q, N and P
    (2, 256, 4, 64, 128, 20.0),     # steep decay: cum_i - cum_j ~ 1e3
    (2, 256, 12, 64, 128, 1.0),     # three whole groups of four heads
    (2, 200, 6, 64, 128, 1.0),      # a last group of two heads, ragged Q
    (16, 16, 8, 16, 16, 1.0),       # Jamba's smoke prefill: chunks of 16
])
def test_ssd_intra_kernel_close(cuda, BC, Q, H, P, N, decay):
    xdt, a, b, c = _ssd_inputs(cuda, BC, Q, H, P, N, decay)
    launches = dops.SSD_INTRA.launches
    got = dops.ssd_intra(xdt, a, b, c)
    want = dref.ssd_intra_ref(xdt, a, b, c)
    torch.cuda.synchronize()
    assert dops.SSD_INTRA.launches == launches + 1
    if Q == 256:    # above the diagonal exp(cum_i - cum_j) overflows
        assert float((a.cumsum(1)[:, 0] - a.cumsum(1)[:, -1]).max()) > 88.8
    for name, g, w, rel in zip(("y", "state", "cum"), got, want,
                               (1e-4, 1e-4, 3e-5)):
        assert bool(torch.isfinite(g).all()), name
        assert g.shape == w.shape, name
        err = float((g - w).abs().max())
        assert err <= rel * float(w.abs().max()), (name, err)


def test_ssd_intra_head_swap_control_fails(cuda):
    """The limit can fail: the kernel given ``a`` with heads 0 and 1
    swapped, held to the plain version on the true ``a``, misses y's."""
    xdt, a, b, c = _ssd_inputs(cuda, 2, 256, 8, 64, 128, 1.0)
    swapped = a[:, :, [1, 0, *range(2, 8)]].contiguous()
    y = dops.ssd_intra(xdt, swapped, b, c)[0]
    want = dref.ssd_intra_ref(xdt, a, b, c)[0]
    assert float((y - want).abs().max()) > 1e-4 * float(want.abs().max())


def test_checkpointer_stages_through_host_memory(cuda, tmp_path):
    """``Checkpointer.maybe_save`` of a state on the card raises
    ``max_memory_allocated`` by no more than its largest leaf (it stages
    into pinned host buffers, no second copy on the card); an in-place
    update queued right after the save never reaches the files; an
    in-place ``restore`` keeps the card's peak level and brings the saved
    leaves back bit for bit."""
    from repro_torch.train import checkpoint as ckpt
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = {"w": torch.randn(32 << 20, generator=gen, device=cuda),
             "m": torch.randn(8 << 20, generator=gen, device=cuda)
             .to(torch.bfloat16),
             "v": torch.randn((1024, 4096), generator=gen, device=cuda),
             "step": torch.tensor(7, dtype=torch.int32, device=cuda)}
    want = {k: v.clone().cpu() for k, v in state.items()}
    largest = max(t.numel() * t.element_size() for t in state.values())
    ck = ckpt.Checkpointer(tmp_path, interval_steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ck.maybe_save(1, state)
    for t in state.values():
        t.add_(1)                          # the next step, in place
    ck.close()
    torch.cuda.synchronize()
    assert not ck.errors and ck.saves == 1
    assert torch.cuda.max_memory_allocated() - base <= largest
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = ckpt.restore(tmp_path, state)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() == base
    for k, v in want.items():
        assert got[k] is state[k] and got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), v), k


def test_overlapped_clustered_capture_on_a_staging_stream(cuda):
    """The clustered overlap pipeline on the card: four fused chunks of a
    producer whose every chunk is big enough for the staging copy to
    still run when the next chunk's collect starts, into a clustered ring
    (2 client + 2 db ranks of the card, the element cut over the db
    ranks) with the copies on the staging stream.  The table equals the
    serial run's bit for bit, the staged tensors are the store's own
    (never the collect buffers), and the hops count one a chunk."""
    from repro_torch.core import Client, StoreServer, TableSpec
    from repro_torch.core import deployment as dep
    from repro_torch.core import store as S
    from repro_torch.parallel.sharding import ElemSharding

    tables = {}
    for overlap in (True, False):
        d = dep.make_clustered_1d(devices=["cuda:0"] * 4, db_fraction=0.5,
                                  axis="space", elem_spec=(None, "space"),
                                  overlap=overlap)
        es = ElemSharding(d.client_mesh, (None, "space"))
        srv = StoreServer(d)
        srv.create_table(TableSpec("f", shape=(4, 1 << 18), capacity=6))
        cli = Client(srv)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step(c, t):
            x = torch.randn(4, 1 << 18, device="cuda", generator=gen)
            for _ in range(20):       # keep the producer's stream busy
                x = torch.sin(x) + 0.5 * x
            return c, S.make_key(0, t), x

        for i in range(4):
            cli.capture_scan("f", step, None, 4, t0=4 * i, elem_sharding=es)
        if overlap:
            assert cli._staging["f"].pending
            slot = cli._staging["f"]._in_flight
            # the copies on the staging stream, their sources held
            assert slot.staged.ready is not None and slot.staged._sources
            assert all(b.device.type == "cuda" for b in slot.values.blocks)
        cli.drain_captures("f")
        torch.cuda.synchronize()
        st = srv.stats()
        assert st["staged_transfers"] == 4
        assert st["op_count"] == 4 + overlap
        tables[overlap] = S.copy_state(srv.checkout("f"))
    a, b = tables[True], tables[False]
    assert torch.equal(S.whole_slab(a.slab), S.whole_slab(b.slab))
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
