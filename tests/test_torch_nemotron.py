"""Port parity for Nemotron-4: Adafactor, the smoke model, the flash path
at its head dim of 192 and the train step's gradients at one
micro-batch, against the JAX reference, in fp32 unless a case says
otherwise.

Both packages get the same weights, gradients and optimizer state
(numpy, from a seed, in the reference's layout;
``tests/_torch_parity.np_lm_params``).  The reference runs jitted, once a
case; its compile-and-run time is recorded as the junit property
``reference_jit_compile_s``.

Tolerances: Adafactor over 10 steps of the clip, the schedule and the
factored update (1-D, 2-D and stacked 3-D leaves; the block size
``PIECE`` lowered so that a leaf runs in several blocks of rows and of
whole matrices): ``vr``/``vc`` within rtol 1e-5 (fp32 means over blocks,
summed in another order), each step's update within 1e-5 of the leaf's
largest entry; bf16 gradients (handed on by the clip as ``Scaled``) the
same moments, the updates within one bf16 rounding (2^-8) of the leaf's
largest.  The smoke model's hidden states, logits, every cache leaf and
2 decode steps within atol 2e-4 (``tests/test_torch_lm.py``'s), one
Adafactor train step's params, ``vr``, ``vc`` and metrics within 1e-4 of
each leaf's largest entry (``tests/test_torch_lm_train.py``'s).  A
narrow model with ``d_head=192``: loss and every gradient through the
reference's Pallas flash kernels in interpret mode against the port's
CPU paths within atol 2e-4.  The train step at ``grad_accum == 1`` hands
the optimizer autograd's gradients in their own dtype, and its result is
``torch.equal`` to the step that copies them to fp32 first.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_lm_params
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train.train_state import TrainState as JTrainState


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tcfgs, tlm, topt, tsteps, tstate, tshard, tree_map, \
        tree_leaves, value_and_grad
    import torch
    from repro_torch import configs as tcfgs
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm as tlm
    from repro_torch.parallel import sharding as tshard
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_state as tstate
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad
    torch.set_num_threads(1)


NEMOTRON, PHI4 = "nemotron_4_340b", "phi4_mini_3_8b"
ATOL = 2e-4
START_STEP = 1999       # the schedule's last warmup step: lr 1e-2


def _flat(tree, path=""):
    """{path: numpy array} over nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _flat(t, f"{path}/{i}").items()}
    if hasattr(tree, "detach"):
        tree = tree.detach().float().numpy()
    return {path: np.asarray(tree, np.float32)}


def _leaf_close(got, want, rel, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        assert err <= rel * max(float(np.abs(w).max()), 1e-30), \
            (what, path, err)


def _optimizer_tree(rng, scale=1.0):
    """A 1-D leaf, a 2-D one and a stacked [periods, rows, cols] one."""
    return {"norm": (scale * rng.standard_normal(7)).astype(np.float32),
            "w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "stacked": (scale * rng.standard_normal((3, 4, 5)))
            .astype(np.float32)}


def _to_torch(tree, dtype=None):
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=dtype),
                    tree)


# PIECE 8 cuts every factored leaf into blocks of rows (one matrix's
# rows at a time); 24 runs the stacked leaf one whole matrix a block
@pytest.mark.parametrize("piece", [None, 8, 24])
def test_adafactor_matches_reference(piece, monkeypatch):
    if piece is not None:
        monkeypatch.setattr(topt, "PIECE", piece)
    rng = np.random.default_rng(41)
    params = _optimizer_tree(rng)
    sched_j = jopt.warmup_cosine(1e-2, 3, 10)
    sched_t = topt.warmup_cosine(1e-2, 3, 10)
    jtx = jopt.chain(jopt.clip_by_global_norm(1.0), jopt.adafactor(sched_j))
    ttx = topt.chain(topt.clip_by_global_norm(1.0), topt.adafactor(sched_t))
    jstate, jp = jtx.init(params), params
    tparams = _to_torch(params)
    tstate_ = ttx.init(tparams)
    for i in range(10):       # norms above and below the clip's limit
        g = _optimizer_tree(rng, 3.0 if i % 2 else 0.1)
        jup, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jopt.apply_updates(jp, jup)
        tup, tstate_ = ttx.update(_to_torch(g), tstate_, tparams)
        _leaf_close(tup, jup, 1e-5, f"updates, step {i}")
        tparams = topt.apply_updates(tparams, tup, inplace=True)
        assert int(tstate_[1].step) == int(jstate[1].step) == i + 1
        for name in ("vr", "vc"):
            got = _flat(getattr(tstate_[1], name))
            want = _flat(getattr(jstate[1], name))
            assert sorted(got) == sorted(want)
            for path, w in want.items():
                assert got[path].shape == w.shape, (name, path)
                np.testing.assert_allclose(got[path], w, rtol=1e-5,
                                           atol=1e-30, err_msg=name + path)
    _leaf_close(tparams, jp, 1e-5, "params")


def test_adafactor_takes_bf16_gradients_through_the_clip():
    """bf16 gradients (one micro-batch of a bf16 model): the clip hands
    them on as ``Scaled``, untouched; Adafactor reads them in fp32 times
    the clip's factor, as the reference's clip makes them, and writes its
    update into their storage."""
    rng = np.random.default_rng(43)
    params = _optimizer_tree(rng)
    g = _optimizer_tree(rng, 3.0)
    g_bf16 = _to_torch(g, torch.bfloat16)
    g_exact = tree_map(lambda t: t.float().numpy(), g_bf16)
    jtx = jopt.chain(jopt.clip_by_global_norm(1.0), jopt.adafactor(1e-2))
    ttx = topt.chain(topt.clip_by_global_norm(1.0), topt.adafactor(1e-2))
    jup, jstate = jtx.update(jax.tree.map(jnp.asarray, g_exact),
                             jtx.init(params), params)
    grads = tree_map(torch.clone, g_bf16)
    tup, tstate_ = ttx.update(grads, ttx.init(_to_torch(params)), None)
    assert tup is grads and {t.dtype for t in tree_leaves(tup)} \
        == {torch.bfloat16}
    for name in ("vr", "vc"):
        got, want = (_flat(getattr(s[1], name)) for s in (tstate_, jstate))
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-30,
                                       err_msg=name + path)
    _leaf_close(tup, jup, 2.0 ** -8, "bf16 updates")


def _smoke(impl=None):
    jcfg = jget_smoke(NEMOTRON)
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(NEMOTRON),
                               **(impl or {}))
    return jcfg, tcfg


B, S, T_MAX, N_DECODE = 2, 32, 36, 2


def test_smoke_model_matches_reference(record_property):
    """forward, prefill (every cache leaf) and 2 decode steps of the
    smoke config, the port's plans ``"xla"`` (chunked at its
    ``attn_chunk``) and ``"flash"`` (the kernels' plain versions on the
    CPU) against the reference's plain plan."""
    jcfg, _ = _smoke()
    params = np_lm_params(jcfg, seed=47)
    rng = np.random.default_rng(48)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (N_DECODE, B, 1)).astype(np.int32)
    t0 = time.perf_counter()
    hidden, logits, caches = jax.jit(
        lambda p, t: (jlm.forward(p, jcfg, t)[0],
                      *jlm.prefill(p, jcfg, t, t_max=T_MAX)[:2]))(
        params, tokens)
    decode = jax.jit(lambda p, c, t, i: jlm.decode_step(p, jcfg, c, t, i))
    want = [(np.asarray(logits), _cache_arrays(caches))]
    for i in range(N_DECODE):
        step_logits, caches = decode(params, caches, steps[i], S + i)
        want.append((np.asarray(step_logits), _cache_arrays(caches)))
    record_property("reference_jit_compile_s", time.perf_counter() - t0)
    for impl in ({"attn_impl": "xla"}, {"attn_impl": "flash"}):
        _, tcfg = _smoke(impl)
        tparams = tshard.lm_params_from_numpy(params, tcfg, device="cpu")
        tt = torch.from_numpy(tokens)
        with torch.no_grad():
            th = tlm.forward(tparams, tcfg, tt)[0]
            np.testing.assert_allclose(th.numpy(), np.asarray(hidden),
                                       atol=ATOL)
            # the port's decode updates the caches in place: read each
            # step's leaves as it comes
            tl, tcaches, pos = tlm.prefill(tparams, tcfg, tt, t_max=T_MAX)
            assert pos == S
            got = [(tl.numpy(), _cache_arrays(tcaches))]
            for i in range(N_DECODE):
                tl, tcaches = tlm.decode_step(
                    tparams, tcfg, tcaches, torch.from_numpy(steps[i]),
                    S + i)
                got.append((tl.numpy(), _cache_arrays(tcaches)))
        for i, ((tl, tc), (wl, wc)) in enumerate(zip(got, want)):
            where = f"{impl} step {i}"
            np.testing.assert_allclose(tl, wl, atol=ATOL, err_msg=where)
            assert [n for n, _ in tc] == [n for n, _ in wc], where
            for (name, g), (_, w) in zip(tc, wc):
                assert g.shape == w.shape, (where, name)
                np.testing.assert_allclose(g, w, atol=ATOL,
                                           err_msg=f"{where}: {name}")


def _cache_arrays(caches):
    """(name, float32 copy) per cache field, pattern position by
    position."""
    return [(f"{i}.{f}", np.array(
        getattr(c, f).numpy() if hasattr(getattr(c, f), "numpy")
        else getattr(c, f), dtype=np.float32))
        for i, c in enumerate(caches) for f in c._fields]


def test_smoke_adafactor_train_step_matches_reference(record_property):
    """One train step of the smoke config from a mid-training Adafactor
    state (step 1999, random positive ``vr``/``vc``): the clip, the
    schedule's 1e-2 peak and the factored update over the model's
    stacked leaves."""
    jcfg, tcfg = _smoke()
    params = np_lm_params(jcfg, seed=51)
    rng = np.random.default_rng(52)
    zero = jopt.adafactor().init(params)
    vr = jax.tree.map(lambda a: (1e-6 * rng.random(a.shape) + 1e-8)
                      .astype(np.float32), zero.vr)
    vc = jax.tree.map(lambda a: (1e-6 * rng.random(a.shape) + 1e-8)
                      .astype(np.float32), zero.vc)
    tokens = rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    labels = tokens.copy()
    labels[:, :3] = -1
    state = JTrainState(
        params=jax.tree.map(jnp.asarray, params),
        opt_state=((), jopt.AdafactorState(
            step=jnp.asarray(START_STEP, jnp.int32),
            vr=jax.tree.map(jnp.asarray, vr),
            vc=jax.tree.map(jnp.asarray, vc))),
        step=jnp.asarray(START_STEP, jnp.int32))
    t0 = time.perf_counter()
    jnew, jmetrics = jax.jit(jmake_train_step(jcfg))(
        state, {"tokens": tokens, "labels": labels})
    record_property("reference_jit_compile_s", time.perf_counter() - t0)

    tstate_ = tstate.train_state_from_numpy(
        params, tcfg, step=START_STEP, device="cpu",
        vr=jax.tree.map(np.asarray, vr), vc=jax.tree.map(np.asarray, vc))
    assert isinstance(tstate_.opt_state[1], topt.AdafactorState)
    tnew, tmetrics = tsteps.make_train_step(tcfg)(
        tstate_, {"tokens": torch.from_numpy(tokens),
                  "labels": torch.from_numpy(labels)})
    assert int(tnew.step) == int(jnew.step) == START_STEP + 1
    assert int(tnew.opt_state[1].step) == int(jnew.opt_state[1].step)
    for k, v in jmetrics.items():
        assert abs(float(tmetrics[k]) - float(v)) \
            <= 1e-4 * max(abs(float(v)), 1e-30), k
    _leaf_close(tnew.params, jnew.params, 1e-4, "params")
    _leaf_close(tnew.opt_state[1].vr, jnew.opt_state[1].vr, 1e-4, "vr")
    _leaf_close(tnew.opt_state[1].vc, jnew.opt_state[1].vc, 1e-4, "vc")
    moved = [float(np.abs(a - b).max()) for a, b in zip(
        _flat(tnew.params).values(), _flat(params).values())]
    assert min(moved) > 0


# one layer, Nemotron-4's head dim and a 2:1 GQA; S = 128, one reference
# tile of the flash kernels
D192 = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, d_head=192,
            d_ff=128, vocab=256, attn_chunk=64, ce_chunk=0)


def test_dh192_flash_path_matches_reference(record_property):
    """A narrow model at ``d_head=192``: the loss and every parameter
    gradient through the reference's Pallas forward and backward kernels
    (``attn_impl="flash_interpret"``) against the port's CPU paths, the
    kernels' autograd Function over their plain versions
    (``"flash_interpret"``) and plain attention (``"xla"``)."""
    jcfg = dataclasses.replace(jget_smoke(NEMOTRON), **D192,
                               attn_impl="flash_interpret")
    params = np_lm_params(jcfg, seed=55)
    rng = np.random.default_rng(56)
    tokens = rng.integers(0, jcfg.vocab, (1, 128)).astype(np.int32)
    t0 = time.perf_counter()
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, t: jlm.lm_loss(p, jcfg, t, t), has_aux=True))(
        params, tokens)
    record_property("reference_jit_compile_s", time.perf_counter() - t0)
    want = _flat(grads)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens)}
    for impl in ("flash_interpret", "xla"):
        tcfg = dataclasses.replace(tcfgs.get_smoke_config(NEMOTRON), **D192,
                                   attn_impl=impl)
        assert tcfg.head_dim == 192
        tparams = tshard.lm_params_from_numpy(params, tcfg, device="cpu")
        loss_fn = tsteps._loss_fn(tcfg)
        (t_loss, _), t_grads = value_and_grad(
            lambda p: loss_fn(p, batch), tparams, has_aux=True)
        np.testing.assert_allclose(float(t_loss), float(loss), atol=ATOL)
        got = _flat(t_grads)
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=ATOL,
                                       err_msg=f"{impl} {path}")


def _step_both_ways(arch, monkeypatch, dtype):
    """One train step at ``grad_accum == 1`` as the port runs it, and the
    same step with every gradient first copied to fp32 (the port's path
    before it handed autograd's gradients on): (handed, state, state
    of the copying step)."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config(arch), dtype=dtype,
                              grad_accum=1)
    specs = tsteps.model_specs(cfg)
    rng = np.random.default_rng(61)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 32)).astype(np.int64))
    batch = {"tokens": tokens, "labels": tokens}

    def fresh():
        return tstate.init_train_state(torch.Generator().manual_seed(3),
                                       cfg, specs, tstate.make_tx(cfg),
                                       device="cpu")

    handed = []
    make_tx = tsteps.make_tx

    def spying_tx(c):
        tx = make_tx(c)

        def update(grads, state, params):
            inner = grads.grads if isinstance(grads, topt.Scaled) else grads
            handed.append({g.dtype for g in tree_leaves(inner)})
            return tx.update(grads, state, params)
        return topt.GradientTransformation(tx.init, update)

    monkeypatch.setattr(tsteps, "make_tx", spying_tx)
    new, metrics = tsteps.make_train_step(cfg)(fresh(), batch)
    monkeypatch.setattr(tsteps, "_owned", lambda gs: [
        g.to(torch.float32, memory_format=torch.contiguous_format)
        for g in gs])
    old, old_metrics = tsteps.make_train_step(cfg)(fresh(), batch)
    for k in metrics:
        assert torch.equal(metrics[k], old_metrics[k]), k
    return handed, new, old


@pytest.mark.parametrize("arch,dtype", [(PHI4, "float32"),
                                        (PHI4, "bfloat16"),
                                        (NEMOTRON, "bfloat16")])
def test_train_step_hands_autograd_gradients_to_the_optimizer(
        arch, dtype, monkeypatch):
    """At ``grad_accum == 1`` the optimizer gets the gradients in the
    params' dtype (bf16 ones through the clip's ``Scaled``), and the step
    is ``torch.equal`` — params and optimizer state — to the step that
    first copies them to fp32: Phi-4-mini's AdamW step (fp32, its smoke
    config as it is, and bf16) and Nemotron-4's Adafactor step (bf16)."""
    dt = getattr(torch, dtype)
    handed, new, old = _step_both_ways(arch, monkeypatch, dt)
    assert handed[0] == {dt} and handed[1] == {torch.float32}
    for a, b in zip(tree_leaves(new), tree_leaves(old)):
        assert a.dtype == b.dtype and torch.equal(a, b)

