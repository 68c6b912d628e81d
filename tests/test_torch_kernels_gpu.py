"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Needs a CUDA device and ``nvcc`` (each test skips without a card; the
check happens inside the fixture).  Imports no JAX, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

probe, sample and gather must agree exactly; the QuadConv contraction
within fp32 rounding (1e-5 relative to the output's magnitude), and bit
for bit between batch sizes (its summation order does not depend on B).
The contraction's autograd Function with the kernel forward gives the
same gradients as with ``mode="ref"`` (its backward is the same einsums
either way) and an output within the forward's tolerance.
"""

import pytest


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, qops, qref, sops, sref
    import torch
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


@pytest.mark.parametrize("B,I,C,J,O", [
    (8, 4096, 4, 64, 16),      # encoder block 0 (J cut: the kernel's j
    (8, 1024, 16, 64, 16),     # blocks are independent), block 1
    (3, 40, 4, 10, 16),        # ragged tile and j-group tails
    (11, 70, 16, 5, 16),       # more batch rows than one block holds
    (2, 16, 8, 9, 2),
])
def test_quadconv_kernel_close(cuda, B, I, C, J, O):
    gen = torch.Generator(device=cuda).manual_seed(2)
    f = torch.randn((B, I, C), generator=gen, device=cuda)
    w = torch.rand((I,), generator=gen, device=cuda) / I
    g = torch.randn((J, I, O, C), generator=gen, device=cuda)
    out = qops.quadconv_contract(f, w, g)
    want = qref.quadconv_contract_ref(f, w, g)
    tol = 1e-5 * float(want.abs().max())
    assert float((out - want).abs().max()) <= tol
    # a row's bits do not depend on the batch it rides in
    for b in range(B):
        one = qops.quadconv_contract(f[b:b + 1].contiguous(), w, g)
        assert torch.equal(one[0], out[b])


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
