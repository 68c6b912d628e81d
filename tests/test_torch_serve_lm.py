"""Port parity for LM serving: ``repro_torch.serve.decode``'s
``greedy_generate`` and continuous-batching ``serve_loop``, the capture
hook ``Client.send_step`` and the launcher, against the JAX reference at
the smoke configs (fp32; the reference with its kernels in interpret
mode, as ``tests/test_torch_lm.py`` runs it).

Greedy ids can agree only where the argmax is not a near-tie: both
packages' logits agree within ``TOL`` (2e-4, ``tests/test_torch_lm.py``),
so a token is compared where the reference's top-2 logit margin exceeds
``TOL``, and each sequence is compared up to its first token that does
not.  The reference's logits are read where it takes their argmax, on
the host (``repro.serve.decode`` is handed a recording ``jnp``), and its
``prefill`` and ``decode_step`` are compiled once for the file instead
of once per call; nothing in the reference changes.  ``serve_loop`` must take the same number of steps and
complete the same requests with the same tokens — including the
reference's quirks: all slots share ``pos = max(pos_per_slot)``, and a
slot still feeding its prompt receives a 0 whenever another slot emits.
``send_step`` must leave byte-identical tables.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_lm_params
from repro.configs import get_smoke_config as jget_smoke
from repro.core import Client as JClient
from repro.core import StoreServer as JServer
from repro.core import TableSpec as JTableSpec
from repro.models import lm as jlm
from repro.serve import decode as jdecode
from repro.serve.batching import Batcher as JBatcher


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tcfgs, tcore, tdecode, tlaunch, tshard, TBatcher
    import torch
    from repro_torch import configs as tcfgs
    from repro_torch import core as tcore
    from repro_torch.launch import serve as tlaunch
    from repro_torch.parallel import sharding as tshard
    from repro_torch.serve import decode as tdecode
    from repro_torch.serve.batching import Batcher as TBatcher
    torch.set_num_threads(1)


ARCHS = ("phi4_mini_3_8b", "mamba2_1_3b")
JAX_IMPL = {"phi4_mini_3_8b": {"attn_impl": "flash_interpret"},
            "mamba2_1_3b": {"ssd_impl": "kernel_interpret"}}
PORT_IMPL = {"phi4_mini_3_8b": {"attn_impl": "flash"},
             "mamba2_1_3b": {"ssd_impl": "kernel"}}
TOL = 2e-4
# serve_loop: 3 slots, 5 requests of uneven prompt lengths (later ones are
# admitted while others decode), 5 new tokens each
PROMPT_LENS, MAX_NEW, SLOTS, T_MAX = (4, 6, 5, 3, 4), 5, 3, 16


class _RecordingJnp(types.SimpleNamespace):
    """``jnp`` for ``repro.serve.decode`` that keeps every array whose
    argmax the reference takes (its logits, on the host)."""

    def __init__(self):
        super().__init__(seen=[])

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, x, axis=None):
        self.seen.append(np.asarray(x, np.float32))
        return jnp.argmax(x, axis)


def _margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# the reference's model entry points, each compiled once per config and
# shape for the whole file: greedy_generate (at t_max = T_MAX) and
# serve_loop decode the same [SLOTS, T_MAX] caches
_LM = types.SimpleNamespace(
    prefill=jax.jit(jlm.prefill, static_argnums=1, static_argnames="t_max"),
    decode_step=jax.jit(jlm.decode_step, static_argnums=1),
    init_caches=jlm.init_caches)


@pytest.fixture
def reference(monkeypatch, request):
    """(jax cfg, port cfg, port params, numpy params, recorder) with the
    reference's decode module observed: its ``jnp`` records, its model
    calls go to ``_LM`` (its own per-call ``jax.jit`` wrappers become the
    identity, so the compiled programs are shared)."""
    arch = request.param
    jcfg = dataclasses.replace(jget_smoke(arch), **JAX_IMPL[arch])
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch),
                               **PORT_IMPL[arch])
    params = np_lm_params(jcfg, seed=11)
    rec = _RecordingJnp()
    monkeypatch.setattr(jdecode, "jnp", rec)
    monkeypatch.setattr(jdecode, "lm", _LM)
    monkeypatch.setattr(jdecode, "jax", types.SimpleNamespace(
        jit=lambda fn: fn, tree=jax.tree, eval_shape=jax.eval_shape))
    return (jcfg, tcfg, tshard.lm_params_from_numpy(params, tcfg, "cpu"),
            params, rec)


@pytest.mark.parametrize("reference", ARCHS, indirect=True)
def test_greedy_generate_matches_reference(reference):
    jcfg, tcfg, tparams, params, rec = reference
    prompt = np.random.default_rng(12).integers(0, jcfg.vocab, (3, 8))
    want = np.asarray(jdecode.greedy_generate(
        params, jcfg, jnp.asarray(prompt, jnp.int32), max_new=6,
        t_max=T_MAX))
    got = tdecode.greedy_generate(tparams, tcfg, torch.from_numpy(prompt),
                                  max_new=6, t_max=T_MAX)
    assert got.shape == want.shape == (3, 6)
    # the reference took max_new + 1 argmaxes (the last one unused)
    margins = _margins(np.stack(rec.seen[:6], axis=1))      # [B, max_new]
    compared = 0
    for row in range(3):
        k = int(np.argmax(margins[row] <= TOL)) \
            if (margins[row] <= TOL).any() else 6
        np.testing.assert_array_equal(got[row, :k].numpy(), want[row, :k])
        compared += k
    assert margins[:, 0].min() > TOL and compared >= 12, margins


def _submit(batcher, vocab):
    rng = np.random.default_rng(13)
    for n in PROMPT_LENS:
        batcher.submit([int(t) for t in rng.integers(0, vocab, n)],
                       max_new_tokens=MAX_NEW)
    return batcher


class _HandingBatcher(JBatcher):
    """The reference's batcher, noting for each token it hands out
    (request, token index) → the margin of the logits row it came from,
    when it is the row's argmax (a slot still feeding its prompt is
    handed a 0, which no near-tie can change)."""

    def __init__(self, rec, **kw):
        super().__init__(**kw)
        self.rec = rec
        self.margin = {}

    def record_tokens(self, token_per_slot):
        logits = self.rec.seen[-1]            # this step's, just taken
        for i, req in enumerate(self.slots):
            if req is not None and not req.done:
                tok = int(token_per_slot[i])
                self.margin[req.rid, len(req.tokens)] = (
                    float(_margins(logits[i]))
                    if tok == int(np.argmax(logits[i])) else np.inf)
        super().record_tokens(token_per_slot)


@pytest.mark.parametrize("reference", ARCHS, indirect=True)
def test_serve_loop_matches_reference(reference):
    jcfg, tcfg, tparams, params, rec = reference
    jb = _submit(_HandingBatcher(rec, max_batch=SLOTS), jcfg.vocab)
    tb = _submit(TBatcher(max_batch=SLOTS), jcfg.vocab)
    jdone, jsteps, _ = jdecode.serve_loop(params, jcfg, jb, t_max=T_MAX)
    tdone, tsteps, tps = tdecode.serve_loop(tparams, tcfg, tb, t_max=T_MAX)
    assert len(rec.seen) == jsteps        # one argmax per step
    assert tsteps == jsteps and tps > 0
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert len(tdone) == len(PROMPT_LENS)
    want = {r.rid: r.tokens for r in jdone}
    compared = 0
    for r in tdone:
        assert len(r.tokens) == len(want[r.rid]) == MAX_NEW
        ok = next((i for i in range(MAX_NEW) if jb.margin[r.rid, i] <= TOL),
                  MAX_NEW)
        assert r.tokens[:ok] == want[r.rid][:ok], r.rid
        compared += ok
    assert compared >= len(PROMPT_LENS) * MAX_NEW - 3, jb.margin


def test_send_step_tables_byte_identical():
    """The capture hook: the same logits sent at the same steps leave the
    same ring table (slab, keys, version, ptr, count) and op count."""
    rng = np.random.default_rng(14)
    values = rng.standard_normal((5, 3, 40)).astype(np.float32)
    jserver, tserver = JServer(), tcore.StoreServer(device="cpu")
    jserver.create_table(JTableSpec("serving", shape=(3, 40), capacity=4,
                                    engine="ring"))
    tserver.create_table(tcore.TableSpec("serving", shape=(3, 40),
                                         capacity=4, engine="ring"))
    jclient, tclient = JClient(jserver, rank=2), tcore.Client(tserver,
                                                              rank=2)
    for step, v in zip((8, 16, 24, 32, 40), values):
        jclient.send_step("serving", step, jnp.asarray(v))
        tclient.send_step("serving", step, torch.from_numpy(v))
    js, ts = jserver._state["serving"], tserver._state["serving"]
    np.testing.assert_array_equal(ts.slab.numpy(), np.asarray(js.slab))
    np.testing.assert_array_equal(ts.keys.numpy(),
                                  np.asarray(js.keys).astype(np.int64))
    for f in ("version", "ptr", "count"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert tserver.stats()["op_count"] == jserver.stats()["op_count"] == 5
    assert tclient.timers.summary()["send"]["count"] == 5


def test_launcher_serves_with_capture_on_the_cpu():
    res = tlaunch.run("phi4_mini_3_8b", n_requests=4, batch=2,
                      prompt_len=4, max_new=6, capture=True, smoke=True,
                      device="cpu")
    assert len(res.completed) == 4 and res.steps > 0
    assert all(len(r.tokens) == 6 for r in res.completed)
    table = res.server._state["serving"]
    assert int(table.count) == res.steps // 8
    assert table.slab.shape == (16, 2, 512)
