"""Port parity of the paper's reproducer (``sim/reproducer.py``) and what it
drives: the store verbs ``put_many`` / ``get_many`` / ``latest`` / ``poll``
/ ``valid_count`` / ``table_bytes`` / ``hbm_bytes`` and their client
verbs, ``run_transfer``, ResNet-50 and ``run_inference``, each through
``repro`` and ``repro_torch`` on the same numpy inputs.

Store state (slab, keys, version, ptr, count), watermarks and
``op_count`` are compared exactly.  ResNet-50's logits are held to the
reference's within ``RESNET_RTOL`` of their largest magnitude: both run
fp32 convolutions on the CPU, summed in different orders through 53 layers
(measured: 8.6e-7 and 2.0e-6 of max|logits| at the two input sizes).  The
reference's ``apply_resnet50`` is jitted once per shape; its eager init is
replaced by numpy weights (``_torch_parity.np_resnet50_params``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_resnet50_params
from repro.core import StoreServer as JServer
from repro.core import Client as JClient
from repro.core import store as JS
from repro.ml import resnet as JR
from repro.sim import reproducer as JP

RESNET_RTOL = 2e-5
SHAPE = (2, 3)
EMPTY = 0xFFFFFFFF


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file."""
    global torch, F, TS, TServer, TClient, StoreTimeout, TR, TP
    import torch
    import torch.nn.functional as F
    from repro_torch.core import Client as TClient
    from repro_torch.core import StoreServer as TServer
    from repro_torch.core import StoreTimeout
    from repro_torch.core import store as TS
    from repro_torch.ml import resnet as TR
    from repro_torch.sim import reproducer as TP
    torch.set_num_threads(1)


def _assert_tables(jserver, tserver):
    """Every table of the two servers byte-identical, and the counters."""
    assert jserver.tables() == tserver.tables()
    for name in jserver.tables():
        jst, tst = jserver._state[name], tserver._state[name]
        np.testing.assert_array_equal(tst.slab.numpy(), np.asarray(jst.slab))
        np.testing.assert_array_equal(tst.keys.numpy().astype(np.uint32),
                                      np.asarray(jst.keys))
        np.testing.assert_array_equal(tst.version.numpy(),
                                      np.asarray(jst.version))
        assert int(tst.ptr) == int(jst.ptr)
        assert tserver.watermark_device(name) \
            == jserver.watermark_device(name) == tserver.watermark(name)
    js, ts = jserver.stats(), tserver.stats()
    assert ts["op_count"] == js["op_count"]
    assert ts["watermarks"] == js["watermarks"]


def _read_both(jserver, tserver, verb, *args):
    return (getattr(jserver, verb)(*args), getattr(tserver, verb)(*args))


@pytest.mark.parametrize("capacity", [4, 5])
@pytest.mark.parametrize("engine", ["ring", "hash"])
def test_store_verbs_match_the_reference(engine, capacity):
    """put_many (collisions mod capacity, a batch longer than the table),
    get_many, latest (also with n above the live count), poll, valid_count,
    table_bytes / hbm_bytes, and the client's send_batch / retrieve_step /
    latest_batch: state, watermarks and op_count exact after every verb."""
    rng = np.random.default_rng(capacity)
    jsv, tsv = JServer(), TServer(device="cpu")
    for sv, mod in ((jsv, JS), (tsv, TS)):
        sv.create_table(mod.TableSpec("t", shape=SHAPE, capacity=capacity,
                                      engine=engine))
    assert tsv.hbm_bytes() == jsv.hbm_bytes() \
        == JS.table_bytes(JS.TableSpec("t", SHAPE, capacity=capacity)) \
        == TS.table_bytes(TS.TableSpec("t", SHAPE, capacity=capacity))

    def put_many(keys):
        keys = np.asarray(keys, np.uint32)
        vals = rng.standard_normal((len(keys), *SHAPE)).astype(np.float32)
        jsv.put_many("t", jnp.asarray(keys), jnp.asarray(vals))
        tsv.put_many("t", torch.from_numpy(keys.astype(np.int64)),
                     torch.from_numpy(vals))
        _assert_tables(jsv, tsv)

    def check_latest(n):
        (jv, jk, jok), (tv, tk, tok) = _read_both(jsv, tsv, "latest", "t", n)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tk.numpy().astype(np.uint32),
                                      np.asarray(jk))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        _assert_tables(jsv, tsv)
        return int(np.asarray(jok).sum())

    put_many([1, 6, 11])              # 1, 6, 11 collide mod 5
    live = jsv.valid_count("t")
    assert tsv.valid_count("t") == live < capacity
    assert check_latest(capacity) == live    # empty slots tie at version 0
    put_many(np.arange(20, 27))       # longer than the table
    put_many([2, 3, 2 + capacity])
    for n in (1, 2, capacity):
        check_latest(n)
    q = np.array([2, 3, 2 + capacity, 26, 999, EMPTY, 25], np.uint32)
    (jv, jf), (tv, tf) = (jsv.get_many("t", jnp.asarray(q)),
                          tsv.get_many("t", q.astype(np.int64)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    hits = [tsv.poll("t", int(key)) for key in q]
    assert hits == [jsv.poll("t", int(key)) for key in q]
    assert hits == list(np.asarray(jf)) and not hits[5]   # EMPTY_KEY
    _assert_tables(jsv, tsv)
    # the client verbs the reproducer calls
    jc, tc = JClient(jsv), TClient(tsv)
    vals = rng.standard_normal((3, *SHAPE)).astype(np.float32)
    jc.send_batch("t", 7, jnp.asarray(vals))
    tc.send_batch("t", 7, torch.from_numpy(vals))
    _assert_tables(jsv, tsv)
    for rank in (0, 2, 5):
        (jv, jf), (tv, tf) = (JClient(jsv, rank=rank).retrieve_step(
            "t", rank, 7), TClient(tsv, rank=rank).retrieve_step(
            "t", rank, 7))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert bool(tf) == bool(jf)
    (jv, jk, jok), (tv, tk, tok) = (jc.latest_batch("t", 2),
                                    tc.latest_batch("t", 2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32),
                                  np.asarray(jk))
    _assert_tables(jsv, tsv)
    assert {k: v["count"] for k, v in tc.timers.summary().items()} == \
        {k: v["count"] for k, v in jc.timers.summary().items()}


def test_poll_tensor_times_out_on_a_missing_key():
    """``poll_tensor``: present at once; a missing key raises
    ``StoreTimeout`` naming the tensor (``strict=False``: False)."""
    server = TServer(device="cpu")
    server.create_table(TS.TableSpec("default", shape=SHAPE, capacity=4,
                                     engine="hash"))
    client = TClient(server)
    client.put_tensor("here", torch.ones(SHAPE))
    assert client.poll_tensor("here", timeout=0.05)
    with pytest.raises(StoreTimeout, match="'gone'"):
        client.poll_tensor("gone", timeout=0.02)
    assert client.poll_tensor("gone", timeout=0.01, strict=False) is False
    assert server.stats()["op_count"] >= 4   # one op a probe


@pytest.mark.parametrize("vectorized", [True, False],
                         ids=["vectorized", "per_rank"])
def test_run_transfer_matches_the_reference(vectorized):
    """The reference's payload fed to both loops: the final tables are
    byte-identical, op_count is 2 a step (vectorized) or 2 · n_ranks (per
    rank), the timers count the same calls, and every read returns its
    payload row."""
    cfg = dict(n_ranks=4, bytes_per_rank=1024, iterations=3, warmup=1)
    jcfg, tcfg = JP.ReproducerConfig(**cfg), TP.ReproducerConfig(**cfg)
    assert tcfg.table_spec().capacity == jcfg.table_spec().capacity
    data = np.array(JP._payload(jcfg))
    jsv, tsv = JServer(), TServer(device="cpu")
    jt = JP.run_transfer(jcfg, jsv, vectorized=vectorized)
    reads = []
    tt = TP.run_transfer(tcfg, tsv, vectorized=vectorized, data=data,
                         on_read=lambda step, v, f: reads.append((v, f)))
    _assert_tables(jsv, tsv)
    steps = cfg["warmup"] + cfg["iterations"]
    assert tsv.stats()["op_count"] == \
        (2 if vectorized else 2 * cfg["n_ranks"]) * steps
    assert {k: v["count"] for k, v in tt.summary().items()} == \
        {k: v["count"] for k, v in jt.summary().items()}
    assert len(reads) == steps
    for values, founds in reads:
        assert bool(founds.all())
        np.testing.assert_array_equal(values.numpy(), data)


_REF_LOGITS: dict = {}


def _inputs(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape) \
        .astype(np.float32)


def _reference_logits(params_np, shape):
    """The reference's logits, its forward jitted once per shape."""
    if shape not in _REF_LOGITS:
        pj = jax.tree.map(jnp.asarray, params_np)
        _REF_LOGITS[shape] = np.asarray(
            jax.jit(JR.apply_resnet50)(pj, jnp.asarray(_inputs(shape))))
    return _REF_LOGITS[shape]


@pytest.fixture(scope="module")
def resnet_params():
    return np_resnet50_params(0)


def _close(got, want) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 3, 33, 33)],
                         ids=["even", "odd"])
def test_resnet50_matches_the_reference(resnet_params, shape):
    """Full width (stages 3-4-6-3, 1000 classes); the even input pads
    SAME asymmetrically at every stride-2 layer, the odd one symmetrically
    at the stem."""
    want = _reference_logits(resnet_params, shape)
    params = TR.resnet50_from_numpy(resnet_params, device="cpu")
    assert params["stages"][1][0]["conv2"].shape == (3, 3, 128, 128)
    got = TR.apply_resnet50(params, torch.from_numpy(_inputs(shape)))
    assert tuple(got.shape) == (shape[0], 1000)
    assert _close(got.numpy(), want) <= RESNET_RTOL


def test_resnet50_symmetric_stem_control_fails(resnet_params):
    """The stem padded as ``nn.Conv2d(padding=3)`` and ``MaxPool2d(3, 2,
    padding=1)`` pad it, symmetrically: the same shapes, and logits far
    outside the tolerance."""
    shape = (2, 3, 32, 32)
    want = _reference_logits(resnet_params, shape)
    params = TR.resnet50_from_numpy(resnet_params, device="cpu")
    x = torch.from_numpy(_inputs(shape))
    h = F.conv2d(x, params["stem"].permute(3, 2, 0, 1), stride=2, padding=3)
    h = F.max_pool2d(F.relu(TR._bn(h, params["bn_stem"])), 3, 2, padding=1)
    got = TR._trunk(params, h)
    assert tuple(got.shape) == want.shape
    assert _close(got.numpy(), want) > 100 * RESNET_RTOL


def test_resnet50_runs_on_the_card_by_default(monkeypatch, resnet_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.init_resnet50(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.resnet50_from_numpy(resnet_params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TServer()                     # so no reproducer loop either
    p = TR.init_resnet50(torch.Generator().manual_seed(0), num_classes=10,
                         device="cpu")
    assert p["stem"].shape == (7, 7, 3, 64) and p["fc"]["w"].shape \
        == (2048, 10)


@pytest.mark.parametrize("fused", [False, True],
                         ids=["three_step", "fused"])
def test_run_inference_matches_the_reference(resnet_params, fused):
    """The reference's loop with its jitted ResNet-50 registered as it is,
    the port's through ``fold_registry_axis``: every model output within
    the tolerance of the reference's logits, and the same op_count, timer
    counts and (three-step) output table shape."""
    shape = (2, 3, 32, 32)
    want = _reference_logits(resnet_params, shape)
    cfg = dict(iterations=2, warmup=1)
    jsv = JServer()
    jsv.set_model("resnet50", JR.apply_resnet50,
                  jax.tree.map(jnp.asarray, resnet_params))
    jt = JP.run_inference(JP.ReproducerConfig(**cfg), jsv, "resnet50",
                          jnp.asarray(_inputs(shape)), fused=fused)
    outs = []

    def spy(params, xs):
        ys = TP.fold_registry_axis(TR.apply_resnet50)(params, xs)
        outs.append(ys)
        return ys

    tsv = TServer(device="cpu")
    tsv.set_model("resnet50", spy,
                  TR.resnet50_from_numpy(resnet_params, device="cpu"))
    tt = TP.run_inference(TP.ReproducerConfig(**cfg), tsv, "resnet50",
                          torch.from_numpy(_inputs(shape)), fused=fused)
    assert tsv.stats()["op_count"] == jsv.stats()["op_count"]
    assert {k: v["count"] for k, v in tt.summary().items()} == \
        {k: v["count"] for k, v in jt.summary().items()}
    assert tsv.spec("infer_out").shape == jsv.spec("infer_out").shape \
        == (2, 1000)
    # the output-spec call, then warm-up and timed iterations
    assert len(outs) == 1 + cfg["warmup"] + cfg["iterations"]
    for ys in outs:
        assert tuple(ys.shape) == (1, 2, 1000)
        assert _close(ys[0].numpy(), want) <= RESNET_RTOL
    if not fused:
        y, found = tsv.get("infer_out", TS.name_key("y"))
        assert bool(found) and _close(y.numpy(), want) <= RESNET_RTOL
