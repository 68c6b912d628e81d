"""Port parity: the same store verb sequence through ``repro.core.store``
and ``repro_torch.core.store`` must leave byte-identical tables.

Covers both engines, ring wrap-around, last-writer-wins collisions inside
one batch, masked tails, ``get``'s lowest-slot tie-break, ``get_many`` and
the fused ``serve_batch``.  After every verb: slab, keys (the port holds
the uint32 value in int64), version, ptr and count are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import store as JS


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TS
    import torch
    from repro_torch.core import store as TS


SHAPE = (2, 3)
EMPTY = 0xFFFFFFFF


def _assert_same(jst, tst):
    np.testing.assert_array_equal(tst.slab.numpy(), np.asarray(jst.slab))
    np.testing.assert_array_equal(tst.keys.numpy().astype(np.uint32),
                                  np.asarray(jst.keys))
    assert tst.keys.dtype == torch.int64
    np.testing.assert_array_equal(tst.version.numpy(),
                                  np.asarray(jst.version))
    assert int(tst.ptr) == int(jst.ptr) and int(tst.count) == int(jst.count)
    assert tst.ptr.dtype == tst.count.dtype == torch.int32


class _Pair:
    """One table in each package, driven verb by verb."""

    def __init__(self, engine, capacity, shape=SHAPE, name="t"):
        self.j = JS.TableSpec(name, shape=shape, capacity=capacity,
                              engine=engine)
        self.t = TS.TableSpec(name, shape=shape, capacity=capacity,
                              engine=engine)
        self.jst = JS.init_table(self.j)
        self.tst = TS.init_table(self.t, device="cpu")

    def apply(self, verb, *args):
        jargs = [jnp.asarray(a) for a in args]
        targs = [torch.as_tensor(a) for a in args]
        self.jst = getattr(JS, verb)(self.j, self.jst, *jargs)
        self.tst = getattr(TS, verb)(self.t, self.tst, *targs)
        _assert_same(self.jst, self.tst)


def test_init_table_takes_the_references_positional_order(monkeypatch):
    """``init_table(spec, slab_sharding)`` as the reference orders it, the
    device keyword-only: the same empty table as the reference's."""
    j = JS.TableSpec("t", shape=SHAPE, capacity=3)
    t = TS.TableSpec("t", shape=SHAPE, capacity=3)
    _assert_same(JS.init_table(j, None), TS.init_table(t, None, device="cpu"))
    _assert_same(JS.init_table(j), TS.init_table(t, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.init_table(t, None)           # the card by default, as before


def _vals(rng, n):
    return rng.standard_normal((n, *SHAPE)).astype(np.float32)


@pytest.mark.parametrize("engine", ["ring", "hash"])
def test_verb_sequence_byte_identical(engine):
    rng = np.random.default_rng(0)
    p = _Pair(engine, capacity=5)
    # single puts, one key repeated (hash: idempotent overwrite in place)
    for k in (7, 12, 7):
        p.apply("put", np.uint32(k), _vals(rng, 1)[0])
    # a batch that wraps the ring / collides mod 5 on the hash engine
    p.apply("put_many", np.array([1, 6, 11, 3], np.uint32), _vals(rng, 4))
    # longer than capacity: last-writer-wins inside one batch
    p.apply("put_many", np.arange(20, 27, dtype=np.uint32), _vals(rng, 7))
    # masked tail with collisions among the masked rows
    p.apply("put_masked", np.array([31, 36, 41, 33, 46, 50], np.uint32),
            _vals(rng, 6), np.array([1, 0, 1, 1, 1, 0], bool))
    p.apply("put_masked", np.array([60, 61], np.uint32), _vals(rng, 2),
            np.array([0, 0], bool))
    # reads: present, absent and reserved keys
    for key in (46, 31, 999, EMPTY):
        vj, fj = JS.get(p.j, p.jst, jnp.uint32(key))
        vt, ft = TS.get(p.t, p.tst, key)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        assert bool(ft) == bool(fj)
    q = np.array([46, 31, 999, EMPTY, 41, 26], np.uint32)
    vj, fj = JS.get_many(p.j, p.jst, jnp.asarray(q))
    vt, ft = TS.get_many(p.t, p.tst, q)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert int(TS.valid_count(p.t, p.tst)) == \
        int(JS.valid_count(p.j, p.jst))


def test_get_lowest_slot_wins():
    """Two live slots with one key: ``get`` (argmax over matches) and
    ``get_many`` (the probe) both return the lower slot's row."""
    rng = np.random.default_rng(1)
    p = _Pair("ring", capacity=5)
    vals = _vals(rng, 3)
    for k, v in zip((5, 9, 5), vals):
        p.apply("put", np.uint32(k), v)
    vt, ft = TS.get(p.t, p.tst, 5)
    np.testing.assert_array_equal(vt.numpy(), vals[0])
    np.testing.assert_array_equal(TS.get_many(p.t, p.tst, [5])[0][0].numpy(),
                                  vals[0])


def test_serve_batch_byte_identical():
    """The fused gather → model → masked scatter: the reference vmaps a
    per-element model, the port calls a batched one once; with an
    elementwise model both are exact."""
    rng = np.random.default_rng(2)
    req = _Pair("ring", capacity=6, name="req")
    res = _Pair("ring", capacity=6, shape=(3,), name="res")
    keys = np.array([101, 102, 103, 104, 105], np.uint32)
    req.apply("put_many", keys, _vals(rng, 5))
    scale = np.float32(2.0)   # exact product: no FMA-vs-two-roundings gap

    def jmodel(p, x):
        return x[0] * p + 1.0

    def tmodel(p, xs):
        return xs[:, 0] * p + 1.0

    batches = [(np.array([101, 102, 103, 0], np.uint32),
                np.array([1, 1, 1, 0], bool)),
               (np.array([104, 999, 105, 0], np.uint32),
                np.array([1, 1, 1, 0], bool))]
    for bkeys, mask in batches:
        new_j, ok_j, ys_j = JS.serve_batch(
            req.j, res.j, jmodel, req.jst, res.jst, jnp.asarray(scale),
            jnp.asarray(bkeys), jnp.asarray(mask))
        new_t, ok_t, ys_t = TS.serve_batch(
            req.t, res.t, tmodel, req.tst, res.tst, torch.as_tensor(scale),
            bkeys, mask)
        res.jst, res.tst = new_j, new_t
        _assert_same(res.jst, res.tst)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(ys_t.numpy(), np.asarray(ys_j))
    _assert_same(req.jst, req.tst)      # the request table is only read
