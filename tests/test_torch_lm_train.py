"""Port parity for the LM training slice: ``lm_loss`` and its gradients,
the optimizer, the train step, the token stream and the launcher of
``repro_torch`` against the JAX reference, at the smoke configs in fp32.

Both packages get the same weights (numpy, from a seed, in the
reference's layout; ``tests/_torch_parity.np_lm_params``), the same
tokens and the same optimizer state.  The reference runs jitted, once
per call site; its compile-and-run time is recorded as the junit
property ``reference_jit_compile_s``.

Tolerances: the loss, its metrics and every parameter gradient within
atol 2e-4 (``tests/test_torch_lm.py``'s); the port's gradients with and
without remat bit-identical (the recomputed forward is the same
arithmetic); one train step's params, μ, ν and metrics within 1e-4 of
each leaf's largest entry, and the parameter change itself within 1e-3
of its largest entry (the change is ~3e-4 at the peak learning rate, and
one fp32 rounding of a weight near 1 is 1.2e-7 of it); the optimizer's
pieces within 1e-6 relative; the token stream byte for byte.
"""

import dataclasses
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_lm_params
from repro.configs import get_smoke_config as jget_smoke
from repro.data.pipeline import TokenStream as JTokenStream
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train.train_state import TrainState as JTrainState


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tcfgs, tlm, tlayers, topt, tsteps, tstate, tdata, \
        ttrain, tshard, tree_map, tree_leaves, value_and_grad
    import torch
    from repro_torch import configs as tcfgs
    from repro_torch import data as tdata
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models import layers as tlayers
    from repro_torch.models import lm as tlm
    from repro_torch.parallel import sharding as tshard
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_state as tstate
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad
    torch.set_num_threads(1)


ATOL = 2e-4
PHI4, MAMBA = "phi4_mini_3_8b", "mamba2_1_3b"
START_STEP = 1999       # the schedule's last warmup step: lr 3e-4


def _flat(tree, path=""):
    """{path: numpy array} over nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _flat(t, f"{path}/{i}").items()}
    if hasattr(tree, "detach"):
        tree = tree.detach().numpy()
    return {path: np.asarray(tree, np.float32)}


def _batch(vocab, B, S, seed, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = tokens.copy()
    if masked:                      # a prefix the loss must not count
        labels[:, :3] = -1
    return tokens, labels


def _torch_batch(tokens, labels):
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


LOSS_CASES = [
    # (reference attn_impl, port attn_impl, S, ce_chunk)
    ("flash_interpret", "flash_interpret", 128, 0),   # flash fwd + bwd
    ("xla", "xla", 129, 32),        # full attention, chunked CE (S-1=128)
    ("xla", "xla", 128, 0),         # chunked attention (attn_chunk 64)
]


@pytest.mark.parametrize("j_impl,t_impl,S,ce_chunk", LOSS_CASES,
                         ids=[f"{c[1]}-S{c[2]}-ce{c[3]}" for c in LOSS_CASES])
def test_lm_loss_and_grads_match_reference(j_impl, t_impl, S, ce_chunk,
                                           record_property):
    jcfg = dataclasses.replace(jget_smoke(PHI4), attn_impl=j_impl,
                               ce_chunk=ce_chunk)
    params = np_lm_params(jcfg, seed=11)
    tokens, labels = _batch(jcfg.vocab, 2, S, seed=S)
    t0 = time.perf_counter()
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, t, y: jlm.lm_loss(p, jcfg, t, y), has_aux=True))(
        params, tokens, labels)
    record_property("reference_jit_compile_s", time.perf_counter() - t0)
    want = _flat(grads)

    tcfg = dataclasses.replace(tcfgs.get_smoke_config(PHI4),
                               attn_impl=t_impl, ce_chunk=ce_chunk)
    tparams = tshard.lm_params_from_numpy(params, tcfg, device="cpu")
    batch = _torch_batch(tokens, labels)
    loss_fn = tsteps._loss_fn(tcfg)
    (t_loss, t_metrics), t_grads = value_and_grad(
        lambda p: loss_fn(p, batch), tparams, has_aux=True)
    np.testing.assert_allclose(float(t_loss), float(loss), atol=ATOL)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(t_metrics[k]), float(metrics[k]),
                                   atol=ATOL, err_msg=k)
    got = _flat(t_grads)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=ATOL,
                                   err_msg=path)
    if t_impl == "flash_interpret":
        # remat (and the cotangent cast at each period) recompute the same
        # arithmetic: the gradients do not move by a bit
        rcfg = dataclasses.replace(tcfg, remat=True, bf16_grads=True)
        r_loss_fn = tsteps._loss_fn(rcfg)
        _, r_grads = value_and_grad(lambda p: r_loss_fn(p, batch), tparams,
                                    has_aux=True)
        for a, b in zip(tree_leaves(r_grads), tree_leaves(t_grads)):
            assert torch.equal(a, b)


def _np_state(jcfg, seed):
    """Params, μ and ν in the reference's layout, drawn with numpy."""
    params = np_lm_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    flat_walk = jax.tree_util.tree_map
    mu = flat_walk(lambda a: (1e-3 * rng.standard_normal(a.shape))
                   .astype(np.float32), params)
    nu = flat_walk(lambda a: (1e-6 * rng.random(a.shape) + 1e-8)
                   .astype(np.float32), params)
    return params, mu, nu


def _reference_step(jcfg, params, mu, nu, tokens, labels):
    state = JTrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=((), jopt.AdamState(
            step=jnp.asarray(START_STEP, jnp.int32),
            mu=jax.tree_util.tree_map(jnp.asarray, mu),
            nu=jax.tree_util.tree_map(jnp.asarray, nu))),
        step=jnp.asarray(START_STEP, jnp.int32))
    new, metrics = jax.jit(jmake_train_step(jcfg))(
        state, {"tokens": tokens, "labels": labels})
    return new, {k: float(v) for k, v in metrics.items()}


def _assert_step_matches(jcfg, tcfg, seed, B, S):
    params, mu, nu = _np_state(jcfg, seed)
    tokens, labels = _batch(jcfg.vocab, B, S, seed=seed + 2)
    t0 = time.perf_counter()
    jnew, jmetrics = _reference_step(jcfg, params, mu, nu, tokens, labels)
    compile_s = time.perf_counter() - t0

    state = tstate.train_state_from_numpy(params, tcfg, mu, nu,
                                          step=START_STEP, device="cpu")
    tnew, tmetrics = tsteps.make_train_step(tcfg)(
        state, _torch_batch(tokens, labels))
    assert int(tnew.step) == START_STEP + 1 == int(jnew.step)
    assert int(tnew.opt_state[1].step) == int(jnew.opt_state[1].step)
    assert sorted(tmetrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        assert abs(float(tmetrics[k]) - v) <= 1e-4 * max(abs(v), 1e-30), k
    old = _flat(params)
    for name, got, want in (("params", tnew.params, jnew.params),
                            ("mu", tnew.opt_state[1].mu,
                             jnew.opt_state[1].mu),
                            ("nu", tnew.opt_state[1].nu,
                             jnew.opt_state[1].nu)):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            err = float(np.abs(got[path] - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()), (name, path, err)
            if name == "params":
                dw = w.astype(np.float64) - old[path]
                dg = got[path].astype(np.float64) - old[path]
                assert float(np.abs(dw).max()) > 0, path
                assert float(np.abs(dg - dw).max()) <= 1e-3 * float(
                    np.abs(dw).max()), (path, "parameter change")
    return compile_s


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum, record_property):
    """One step from the same mid-training state (step 1999, random μ and
    ν): clipping, AdamW with decay, fp32 gradient sums over micro-batches."""
    jcfg = dataclasses.replace(jget_smoke(PHI4), grad_accum=accum)
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(PHI4),
                               grad_accum=accum)
    record_property("reference_jit_compile_s", _assert_step_matches(
        jcfg, tcfg, seed=20 + accum, B=2 * accum, S=32))


def test_mamba2_train_step_matches_reference(record_property):
    """Mamba-2 trains through the chunked scan (``ssd_impl="xla"``, the
    reference's default), two chunks of 16."""
    record_property("reference_jit_compile_s", _assert_step_matches(
        jget_smoke(MAMBA), tcfgs.get_smoke_config(MAMBA), seed=30, B=2,
        S=32))


def _random_tree(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((3, 5, 4))).astype(np.float32),
            "b": [(scale * rng.standard_normal(7)).astype(np.float32)]}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rtol=1e-6):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=1e-9,
                                   err_msg=path)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("piece", [8, None])
def test_optimizer_pieces_match_reference(piece, mu_dtype, monkeypatch):
    """``warmup_cosine``, ``global_norm``, ``clip_by_global_norm`` (norm
    above and below the limit), ``adamw``, ``chain``,
    ``scale_by_schedule`` and ``apply_updates`` against the reference's,
    in place as the LM train step runs them, with every leaf cut into
    pieces of 8 elements and with the default piece (no leaf cut), and
    with Adam's μ in fp32 and in bf16 (``mu_dtype``; a bf16 μ bit for
    bit).  The
    reference's gradients are JAX arrays, as in its train step (a NumPy
    gradient would take μ's update out of bf16)."""
    if piece is not None:
        monkeypatch.setattr(topt, "PIECE", piece)
    sched_j = jopt.warmup_cosine(3e-4, 10, 100)
    sched_t = topt.warmup_cosine(3e-4, 10, 100)
    for step in (0, 1, 9, 10, 11, 55, 99, 100, 250):
        np.testing.assert_allclose(
            float(sched_t(torch.tensor(step, dtype=torch.int32))),
            float(sched_j(jnp.asarray(step, jnp.int32))), rtol=1e-6)
    rng = np.random.default_rng(3)
    params, grads = _random_tree(rng), _random_tree(rng)
    np.testing.assert_allclose(float(topt.global_norm(_to_torch(grads))),
                               float(jopt.global_norm(grads)), rtol=1e-6)
    for max_norm in (0.5, 1e3):         # clipping, and not
        jg, _ = jopt.clip_by_global_norm(max_norm).update(grads, (), params)
        tg, _ = topt.clip_by_global_norm(max_norm).update(
            _to_torch(grads), (), _to_torch(params))
        _close(tg, jg)
    jtx = jopt.chain(jopt.clip_by_global_norm(1.0),
                     jopt.adamw(lr=sched_j, b1=0.9, b2=0.95,
                                weight_decay=0.1,
                                mu_dtype=getattr(jnp, mu_dtype)))
    ttx = topt.chain(topt.clip_by_global_norm(1.0),
                     topt.adamw(lr=sched_t, b1=0.9, b2=0.95,
                                weight_decay=0.1,
                                mu_dtype=getattr(torch, mu_dtype)))
    jstate = jtx.init(params)
    tparams = _to_torch(params)
    tstate_ = ttx.init(tparams)
    jp = params
    for i in range(3):
        g = _random_tree(rng, 0.3)
        jup, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jopt.apply_updates(jp, jup)
        tup, tstate_ = ttx.update(_to_torch(g), tstate_, tparams)
        tparams = topt.apply_updates(tparams, tup, inplace=True)
        _close(tparams, jp)
        assert {m.dtype for m in tree_leaves(tstate_[1].mu)} \
            == {getattr(torch, mu_dtype)}
        assert {m.dtype for m in jax.tree.leaves(jstate[1].mu)} \
            == {jnp.dtype(mu_dtype)}
        tmu = tree_map(lambda m: m.float(), tstate_[1].mu)
        if mu_dtype == "float32":
            _close(tmu, jstate[1].mu)       # the clip's norm rounds apart
        else:                   # bit for bit: μ's bf16 rounding absorbs it
            got, want = _flat(tmu), _flat(jstate[1].mu)
            assert sorted(got) == sorted(want)
            for path, w in want.items():
                np.testing.assert_array_equal(got[path], w, err_msg=path)
        _close(tstate_[1].nu, jstate[1].nu)
        assert int(tstate_[1].step) == int(jstate[1].step) == i + 1
    jsc, tsc = (jopt.scale_by_schedule(sched_j),
                topt.scale_by_schedule(sched_t))
    jout, js = jsc.update(grads, jsc.init(params), params)
    tout, ts = tsc.update(_to_torch(grads), tsc.init(tparams), tparams)
    _close(tout, jout)
    assert int(ts.step) == int(js.step) == 1
    # adafactor builds (its parity is tests/test_torch_nemotron.py's)
    af = topt.adafactor()
    assert isinstance(af.init(tparams), topt.AdafactorState)
    # gradients that are not fp32 stay as they are: the clip hands them on
    # wrapped with its factor, which the reference applies in fp32
    bf = {"w": torch.full((3,), 4.0, dtype=torch.bfloat16)}
    out, _ = topt.clip_by_global_norm(1.0).update(bf, (), None)
    assert isinstance(out, topt.Scaled) and out.grads is bf
    assert torch.equal(bf["w"], torch.full((3,), 4.0, dtype=torch.bfloat16))
    assert out.scale.dtype == torch.float32
    np.testing.assert_allclose(float(out.scale),
                               1.0 / (math.sqrt(48.0) + 1e-9), rtol=1e-6)


def test_token_stream_is_the_references():
    """The same numpy draws: byte-identical batches for a seed; the
    prefetcher hands them out as tensors on the device asked for."""
    jit = iter(JTokenStream(512, 2, 64, seed=5))
    tit = iter(tdata.TokenStream(512, 2, 64, seed=5))
    batches = []
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == jb[k].dtype == np.int32
            assert tb[k].tobytes() == jb[k].tobytes()
        batches.append(jb)
    pre = tdata.PrefetchIterator(iter(tdata.TokenStream(512, 2, 64, seed=5)),
                                 buffer_size=2, device="cpu")
    try:
        for jb in batches:
            got = next(pre)
            assert got["tokens"].dtype == torch.int32
            assert got["tokens"].device.type == "cpu"
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          jb["tokens"])
    finally:
        pre.close()
    assert not pre._thread.is_alive()


def test_prefetch_raises_what_its_thread_raised():
    """A failure in the prefetch thread reaches the consumer after the
    batches made before it, instead of ending the stream early."""
    def source():
        yield {"tokens": np.zeros((2, 4), np.int32)}
        raise RuntimeError("copy failed")

    pre = tdata.PrefetchIterator(source(), buffer_size=2, device="cpu")
    try:
        assert next(pre)["tokens"].shape == (2, 4)
        with pytest.raises(RuntimeError, match="copy failed"):
            next(pre)
    finally:
        pre.close()


def test_launcher_runs_on_the_cpu(monkeypatch, tmp_path):
    """``launch.train.run`` at the smoke config: three steps, capture on;
    the params stay in the reference's layout and dtype.  Without a card
    and without a device it raises; with ``ckpt_dir`` it saves the last
    step, ``ckpt_every`` apart (``tests/test_torch_checkpoint.py`` holds
    the resume)."""
    res = ttrain.run(PHI4, steps=3, batch=2, seq_len=32, smoke=True,
                     capture=True, device="cpu", log_every=1)
    assert len(res.losses) == len(res.grad_norms) == len(res.step_s) == 3
    assert all(math.isfinite(x) for x in res.losses + res.grad_norms)
    assert res.tokens_per_s > 0
    assert int(res.state.step) == 3
    assert int(res.server._state["hidden"].count) == 1      # step 0
    cfg = tcfgs.get_smoke_config(PHI4)
    spec_shapes = {k: tuple(v.shape) for k, v in _flat(
        tshard.init_params(tsteps.model_specs(cfg),
                           torch.Generator().manual_seed(0), cfg.dtype,
                           device="cpu")).items()}
    got = _flat(res.state.params)
    assert {k: v.shape for k, v in got.items()} == spec_shapes
    assert {p.dtype for p in tree_leaves(res.state.params)} == {cfg.dtype}
    ttrain.run(PHI4, steps=1, batch=2, seq_len=32, smoke=True,
               device="cpu", ckpt_dir=str(tmp_path), ckpt_every=5)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000001"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.run(PHI4, steps=1, smoke=True)


def test_schedule_and_adam_take_the_references_arguments():
    """``constant_schedule(lr=...)``, and ``adam``/``adamw``'s ``mu_dtype``:
    μ is allocated and kept in it (ν stays fp32), out of place (``adam``)
    and in place (``adamw``), and one step's update equals the fp32-μ
    update to within μ's bf16 rounding."""
    assert topt.constant_schedule(lr=0.25)(7) == 0.25
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((4, 3), generator=gen),
              "b": torch.randn((3,), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen)
             for k, v in params.items()}

    def one_step(make, mu_dtype):
        tx = make(mu_dtype)
        state = tx.init(params)
        assert {m.dtype for m in tree_leaves(state.mu)} == {mu_dtype}
        upd, state = tx.update({k: g.clone() for k, g in grads.items()},
                               state, params)
        assert {m.dtype for m in tree_leaves(state.mu)} == {mu_dtype}
        assert {v.dtype for v in tree_leaves(state.nu)} == {torch.float32}
        return upd

    for make in (lambda d: topt.adam(lr=1e-2, mu_dtype=d),
                 lambda d: topt.adamw(1e-2, 0.9, 0.95, 1e-8, 0.1, d)):
        got, want = (one_step(make, d)
                     for d in (torch.bfloat16, torch.float32))
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=2 ** -7,
                                       atol=0)


def test_unported_training_options_raise():
    cfg = tcfgs.get_smoke_config(PHI4)
    params = tshard.init_params(tsteps.model_specs(cfg),
                                torch.Generator().manual_seed(0),
                                cfg.dtype, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    dots = dataclasses.replace(cfg, remat=True, remat_policy="dots")
    with pytest.raises(NotImplementedError, match="A7"):
        tlm.lm_loss(params, dots, tokens, tokens)
    with torch.no_grad():               # serving never rematerializes
        tlm.forward(params, dots, tokens)
    af = tstate.make_tx(dataclasses.replace(cfg, optimizer="adafactor"))
    assert isinstance(af.init(params)[1], topt.AdafactorState)
    with pytest.raises(NotImplementedError, match="A7"):
        tsteps.make_train_step(dataclasses.replace(
            cfg, frontend="vision", frontend_tokens=4))
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = tlayers.ct_cast(x)
    assert torch.equal(y, x)
    (y.float() * 2).sum().backward()
    assert x.grad.dtype == torch.bfloat16 and torch.equal(
        x.grad, torch.full((3,), 2.0, dtype=torch.bfloat16))
