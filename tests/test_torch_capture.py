"""Port parity: the producer's capture family (``repro_torch``) against
the JAX reference, through ``Client.capture_scan`` on a local server.

The port's ``capture_scan[_multi]`` are host loops over steps (and
ranks); the reference's are one ``lax.scan`` dispatch.  The table they
leave must be byte-identical — slab, keys, version, ptr, count — with
``emit_every`` 2, a ``t0`` offset, and more emitting steps than the ring
holds (wrap-around, last writer wins); and the put counts (cached
watermark) and ``op_count`` must be equal.  The step values are small
integers in fp32, exact in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Client as JClient
from repro.core import StoreServer as JServer
from repro.core import TableSpec as JTableSpec
from repro.core import store as JS


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TClient, TServer, TTableSpec, TS
    import torch
    from repro_torch.core import Client as TClient
    from repro_torch.core import StoreServer as TServer
    from repro_torch.core import TableSpec as TTableSpec
    from repro_torch.core import store as TS
    # tiny shapes: one core, leaving the rest to the other test workers
    torch.set_num_threads(1)


SHAPE = (2, 3)
CAPACITY = 5


def _jstep(carry, rank, t):
    value = jnp.full(SHAPE, 100.0) * rank + t + carry \
        + jnp.arange(6.0).reshape(SHAPE)
    return carry + 1, JS.make_key(rank, t), value


def _tstep(carry, rank, t):
    value = torch.full(SHAPE, 100.0) * rank + t + carry \
        + torch.arange(6.0).reshape(SHAPE)
    return carry + 1, TS.make_key(rank, t), value


def _servers():
    jsrv, tsrv = JServer(), TServer(device="cpu")
    jsrv.create_table(JTableSpec("f", shape=SHAPE, capacity=CAPACITY))
    tsrv.create_table(TTableSpec("f", shape=SHAPE, capacity=CAPACITY))
    return jsrv, tsrv


def _assert_tables_equal(jsrv, tsrv, ops: bool = True):
    js, ts = jsrv.checkout("f"), tsrv.checkout("f")
    np.testing.assert_array_equal(ts.slab.numpy(), np.asarray(js.slab))
    np.testing.assert_array_equal(ts.keys.numpy(),
                                  np.asarray(js.keys).astype(np.int64))
    np.testing.assert_array_equal(ts.version.numpy(), np.asarray(js.version))
    assert int(ts.ptr) == int(js.ptr) and int(ts.count) == int(js.count)
    jstats, tstats = jsrv.stats(), tsrv.stats()
    if ops:
        assert tstats["op_count"] == jstats["op_count"]
    assert tstats["watermarks"] == jstats["watermarks"]
    return tstats


def test_capture_scan_matches_reference():
    """Three chunks: t0 offset 3, emit_every 2; the second chunk alone
    emits more steps (7) than the ring holds (5)."""
    jsrv, tsrv = _servers()
    jcl, tcl = JClient(jsrv), TClient(tsrv)
    jcarry, tcarry = jnp.float32(0.0), torch.tensor(0.0)
    single_j = lambda c, t: _jstep(c, 0, t)          # noqa: E731
    single_t = lambda c, t: _tstep(c, 0, t)          # noqa: E731
    for t0, length in ((3, 4), (7, 14), (21, 3)):
        jcarry = jcl.capture_scan("f", single_j, jcarry, length, 2, t0=t0)
        tcarry = tcl.capture_scan("f", single_t, tcarry, length, 2, t0=t0)
    assert float(tcarry) == float(jcarry) == 21.0
    stats = _assert_tables_equal(jsrv, tsrv)
    puts = sum(JS.capture_emit_count(n, 2, t0)
               for t0, n in ((3, 4), (7, 14), (21, 3)))
    assert stats["op_count"] == 3 and stats["watermarks"]["f"] == puts
    assert TS.capture_emit_count(14, 2, 7) == 7 > CAPACITY


def test_capture_scan_multi_matches_reference():
    """R = 3 ranks with staggered clocks (emission gated on rank 0's),
    so every emitting step writes 3 rows; 2 emitting steps fill the ring
    past its 5 slots within one call."""
    jsrv, tsrv = _servers()
    jcl, tcl = JClient(jsrv), TClient(tsrv)
    t0 = [4, 6, 9]
    jcarry = jcl.capture_scan("f", _jstep, jnp.zeros((3,)), 5, 2,
                              t0=jnp.asarray(t0), n_ranks=3)
    tcarry = tcl.capture_scan("f", _tstep, torch.zeros((3,)), 5, 2, t0=t0,
                              n_ranks=3)
    np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jcarry))
    stats = _assert_tables_equal(jsrv, tsrv)
    assert stats["watermarks"]["f"] == TS.capture_emit_count_multi(3, 5, 2,
                                                                   4) == 9


@pytest.mark.parametrize("ranks", [None, 3])
def test_put_stream_matches_reference(ranks):
    """A trajectory of T steps (of R ranks, time-major) in one op, wrapping
    the ring."""
    rng = np.random.default_rng(8)
    t = 7
    lead = (t,) if ranks is None else (t, ranks)
    keys = rng.integers(0, 2**31, lead).astype(np.uint32)
    values = rng.standard_normal((*lead, *SHAPE)).astype(np.float32)
    jsrv, tsrv = _servers()
    jsrv.put_stream("f", jnp.asarray(keys), jnp.asarray(values))
    tsrv.put_stream("f", keys.astype(np.int64), torch.as_tensor(values))
    stats = _assert_tables_equal(jsrv, tsrv)
    assert stats["op_count"] == 1
    assert stats["watermarks"]["f"] == keys.size


@pytest.mark.parametrize("ranks", [None, 3])
def test_raising_step_leaves_earlier_puts_committed(ranks):
    """A step that raises midway through a capture: the puts made before
    it stay committed with their ptr, count and watermark — the table
    equals the reference's after a capture of just the steps that ran,
    past a ring wrap — and the next capture goes on from there."""
    jsrv, tsrv = _servers()
    jcl, tcl = JClient(jsrv), TClient(tsrv)
    t0, fail_at = 3, 16
    multi = {} if ranks is None else {"n_ranks": ranks}
    jstep = _jstep if ranks else (lambda c, t: _jstep(c, 0, t))
    tstep = _tstep if ranks else (lambda c, t: _tstep(c, 0, t))

    def raising(carry, *rank_t):
        if rank_t[-1] == fail_at:
            raise RuntimeError("step failed")
        return tstep(carry, *rank_t)

    jcarry = jnp.zeros((ranks,)) if ranks else jnp.float32(0.0)
    tcarry = torch.zeros((ranks,)) if ranks else torch.tensor(0.0)
    jcarry = jcl.capture_scan("f", jstep, jcarry, fail_at - t0, 2, t0=t0,
                              **multi)
    with pytest.raises(RuntimeError, match="step failed"):
        tcl.capture_scan("f", raising, tcarry, 20, 2, t0=t0, **multi)
    stats = _assert_tables_equal(jsrv, tsrv, ops=False)
    per_step = ranks or 1
    assert stats["watermarks"]["f"] == 6 * per_step > CAPACITY
    jcl.capture_scan("f", jstep, jcarry, 4, 2, t0=fail_at, **multi)
    tcl.capture_scan("f", tstep, torch.tensor(np.array(jcarry)), 4, 2,
                     t0=fail_at, **multi)
    _assert_tables_equal(jsrv, tsrv, ops=False)
