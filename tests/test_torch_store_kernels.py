"""Port parity: the store access kernels' plain versions (``repro_torch``)
against the JAX reference ops in ``"ref"`` and ``"interpret"`` mode.

Inputs come from numpy seeds; probe and gather must agree EXACTLY (they
are integer lookups and row copies).  The CUDA kernels themselves are held
to these plain versions on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import store as JS
from repro.kernels.store import ops as jops
from repro_torch.core import store as TS
from repro_torch.kernels.store import ops as tops

MODES = ("ref", "interpret")
EMPTY = 0xFFFFFFFF
# one compiled program per call site instead of one per eager op
_jprobe = jax.jit(jops.probe_slots, static_argnums=3)
_jgather = jax.jit(jops.gather_rows, static_argnums=2)


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


def _torch_keys(a: np.ndarray) -> torch.Tensor:
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


@pytest.mark.parametrize("engine", ["ring", "hash"])
def test_get_many_on_tables_matches_reference(engine):
    """The same puts (with a duplicated key) in both packages, then
    ``get_many`` over present, duplicated, absent and reserved keys."""
    rng = np.random.default_rng(5)
    keys = np.array([3, 9, 3, 17, 26, 8], np.uint32)   # 3 twice; hash:
    vals = rng.standard_normal((6, 2, 3)).astype(np.float32)   # 17≡26≡8
    jspec = JS.TableSpec("t", shape=(2, 3), capacity=9, engine=engine)
    tspec = TS.TableSpec("t", shape=(2, 3), capacity=9, engine=engine)
    jst, tst = JS.init_table(jspec), TS.init_table(tspec, "cpu")
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
