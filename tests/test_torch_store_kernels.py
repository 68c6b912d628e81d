"""Port parity: the store access kernels' plain versions (``repro_torch``)
against the JAX reference ops in ``"ref"`` and ``"interpret"`` mode.

Inputs come from numpy seeds; probe, sample and gather must agree EXACTLY
(they are integer lookups and row copies).  For ranks outside
``[0, nvalid)`` the sample kernel is held to the reference's plain
version only: the Pallas kernel returns its *padded* capacity there.  The
CUDA kernels themselves are held to these plain versions on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import uniforms_for_ranks
from repro.core import store as JS
from repro.kernels.store import ops as jops


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TS, tops
    import torch
    from repro_torch.core import store as TS
    from repro_torch.kernels.store import ops as tops


MODES = ("ref", "interpret")
EMPTY = 0xFFFFFFFF
# one compiled program per call site instead of one per eager op
_jprobe = jax.jit(jops.probe_slots, static_argnums=3)
_jgather = jax.jit(jops.gather_rows, static_argnums=2)
_jsample = jax.jit(jops.sample_slots, static_argnums=2)
_jsample_impl = jax.jit(JS.sample_impl, static_argnums=(0, 3))

# version vectors: dead slots between live ones, all live, an empty table
_SAMPLE_CASES = {
    "dead_slots": np.array([0, 3, 0, 0, 7, 1, 0, 2, 9, 0, 0, 4], np.int32),
    "all_live": np.arange(1, 11, dtype=np.int32),
    "empty": np.zeros(7, np.int32),
}


def _probe_case(seed: int, capacity: int = 37, n: int = 19):
    """Keys from a small range (many duplicates), dead slots, EMPTY_KEY
    slots; queries mix present, absent, duplicated and EMPTY_KEY."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 12, capacity).astype(np.uint32)
    keys[rng.random(capacity) < 0.15] = EMPTY
    version = rng.integers(1, 50, capacity).astype(np.int32)
    version[rng.random(capacity) < 0.25] = 0
    query = rng.integers(0, 15, n).astype(np.uint32)
    query[:2] = EMPTY
    return keys, version, query


def _torch_keys(a: np.ndarray) -> "torch.Tensor":
    return torch.as_tensor(a.astype(np.int64))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_probe_matches_reference(seed, mode):
    keys, version, query = _probe_case(seed)
    idx_j, found_j = _jprobe(jnp.asarray(keys), jnp.asarray(version),
                             jnp.asarray(query), mode)
    idx_t, found_t = tops.probe_slots(_torch_keys(keys),
                                      torch.as_tensor(version),
                                      _torch_keys(query))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    # EMPTY_KEY never matches; duplicates resolve to the lowest live slot
    assert not found_t[:2].any()
    live = version > 0
    for q, i in zip(query, idx_t.numpy()):
        hits = np.flatnonzero(live & (keys == q))
        want = hits[0] if q != EMPTY and hits.size else len(keys)
        assert i == want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_matches_reference(dtype, mode):
    rng = np.random.default_rng(3)
    slab = (rng.standard_normal((11, 3, 5)) * 100).astype(dtype)
    slots = rng.integers(0, 11, 9).astype(np.int32)
    rows_j = _jgather(jnp.asarray(slab), jnp.asarray(slots), mode)
    rows_t = tops.gather_rows(torch.as_tensor(slab), torch.as_tensor(slots))
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))


@pytest.mark.parametrize("case", sorted(_SAMPLE_CASES))
def test_sample_slots_matches_reference(case):
    """Every rank from -2 to nvalid + 2 — in range, negative and past the
    live count — against the reference's plain version, exactly; the
    in-range ranks also against the Pallas kernel in interpret mode."""
    version = _SAMPLE_CASES[case]
    nvalid = int((version > 0).sum())
    ranks = np.arange(-2, nvalid + 3, dtype=np.int32)
    got = tops.sample_slots(torch.as_tensor(version), torch.as_tensor(ranks))
    want = _jsample(jnp.asarray(version), jnp.asarray(ranks), "ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    live = np.flatnonzero(version > 0)
    assert list(got.numpy()[2:2 + nvalid]) == list(live)
    assert (got.numpy()[:2] == 0).all()
    assert (got.numpy()[2 + nvalid:] == len(version)).all()
    if nvalid:
        inside = ranks[2:2 + nvalid]
        interp = _jsample(jnp.asarray(version), jnp.asarray(inside),
                          "interpret")
        np.testing.assert_array_equal(got.numpy()[2:2 + nvalid],
                                      np.asarray(interp))


@pytest.mark.parametrize("case", ["dead_slots", "empty"])
def test_store_sample_with_fed_ranks_matches_reference(case):
    """``store.sample`` fed uniforms that give the ranks the reference
    draws inside
    ``sample_impl`` gives the same ``(values, keys, ok)``, exactly."""
    version = _SAMPLE_CASES[case]
    rng = np.random.default_rng(4)
    capacity = len(version)
    spec_j = JS.TableSpec("t", shape=(2, 3), capacity=capacity)
    spec_t = TS.TableSpec("t", shape=(2, 3), capacity=capacity)
    slab = rng.standard_normal((capacity, 2, 3)).astype(np.float32)
    keys = rng.integers(0, 2**31, capacity).astype(np.uint32)
    jst = JS.TableState(jnp.asarray(slab), jnp.asarray(keys),
                        jnp.asarray(version), jnp.int32(0),
                        jnp.int32(int(version.sum())))
    tst = TS.TableState(torch.as_tensor(slab), _torch_keys(keys),
                        torch.as_tensor(version), torch.tensor(0),
                        torch.tensor(int(version.sum())))
    n, key = 9, jax.random.key(11)
    vals_j, keys_j, ok_j = _jsample_impl(spec_j, jst, key, n)
    nvalid = max(int((version > 0).sum()), 1)
    ranks = jax.random.randint(key, (n,), 0, jnp.int32(nvalid))
    vals_t, keys_t, ok_t = TS.sample(
        spec_t, tst, torch.as_tensor(uniforms_for_ranks(ranks, nvalid)))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j))
    assert bool(ok_t) == bool(ok_j) == (case != "empty")


def test_store_sample_from_uniforms_stays_in_range():
    """Uniform draws become ranks in ``[0, nvalid)`` on the device:
    every sampled key is a live one, and u → 1 maps to the last."""
    version = _SAMPLE_CASES["dead_slots"]
    spec = TS.TableSpec("t", shape=(1,), capacity=len(version))
    st = TS.TableState(torch.arange(len(version), dtype=torch.float32)
                       .reshape(-1, 1),
                       torch.arange(len(version), dtype=torch.int64),
                       torch.as_tensor(version), torch.tensor(0),
                       torch.tensor(0))
    u = torch.tensor([0.0, 0.5, 1 - 2**-24, 0.99], dtype=torch.float32)
    _vals, keys, ok = TS.sample(spec, st, u)
    live = np.flatnonzero(version > 0)
    assert bool(ok) and set(keys.tolist()) <= set(live.tolist())
    assert keys.tolist()[0] == live[0] and keys.tolist()[2] == live[-1]


@pytest.mark.parametrize("engine", ["ring", "hash"])
def test_get_many_on_tables_matches_reference(engine):
    """The same puts (with a duplicated key) in both packages, then
    ``get_many`` over present, duplicated, absent and reserved keys."""
    rng = np.random.default_rng(5)
    keys = np.array([3, 9, 3, 17, 26, 8], np.uint32)   # 3 twice; hash:
    vals = rng.standard_normal((6, 2, 3)).astype(np.float32)   # 17≡26≡8
    jspec = JS.TableSpec("t", shape=(2, 3), capacity=9, engine=engine)
    tspec = TS.TableSpec("t", shape=(2, 3), capacity=9, engine=engine)
    jst, tst = JS.init_table(jspec), TS.init_table(tspec, device="cpu")
    for k, v in zip(keys, vals):
        jst = JS.put(jspec, jst, jnp.uint32(k), jnp.asarray(v))
        tst = TS.put(tspec, tst, int(k), torch.as_tensor(v))
    query = np.array([3, 9, 17, 26, 8, 4, EMPTY], np.uint32)
    for mode in MODES:
        vj, fj = JS.get_many(jspec, jst, jnp.asarray(query), mode)
        vt, ft = TS.get_many(tspec, tst, query)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def test_cuda_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on a card has no kernel and
    no plain path: the wrappers raise instead of computing elsewhere."""
    keys = torch.zeros(4, dtype=torch.int64, device="meta")
    version = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.probe_slots(keys, version, keys)
    with pytest.raises(ValueError, match="no kernel"):
        tops.gather_rows(torch.zeros((4, 2), device="meta"),
                         torch.zeros(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tops.sample_slots(version, torch.zeros(2, dtype=torch.int32,
                                               device="meta"))
