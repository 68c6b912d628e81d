"""Port parity for Whisper (``repro_torch.models.whisper``) against the
JAX reference, at the smoke config in fp32.

Both packages get the same weights (numpy, from a seed, in the
reference's ``whisper_specs`` layout; ``tests/_torch_parity.
np_spec_params``), the same frames and tokens.  The reference runs
jitted, compiled at XLA's lowest backend optimization level (the compile,
not the run, is what costs here); on the plain plan one program computes
the forward, the gradients and the train step, which two tests read.  Its
compile-and-run time is recorded as the junit property
``reference_jit_compile_s``.

Tolerances: the config twins, the specs' shapes and ``param_count()``
exact; ``encode``, ``decoder_forward``, ``whisper_loss`` and every
gradient within atol 2e-4 (``tests/test_torch_lm.py``'s), on the plain
plan (``"xla"``) and on the flash route (``"flash_interpret"``: the
reference's Pallas kernels in interpret mode against the port's
autograd Function over the kernels' plain versions; cross-attention is
S = 32 decoder queries against T = 64 encoder keys); the prefill's
logits, self caches (padded to ``t_max``) and cross caches and three
decode steps' logits and caches within atol 2e-4, the cross caches never
written; one train step from a mid-training AdamW state (params, μ, ν,
metrics) within 1e-4 of each leaf's largest entry
(``tests/test_torch_lm_train.py``'s).
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_spec_params
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import whisper as jwhisper
from repro.train import optimizer as jopt
from repro.train.train_state import TrainState as JTrainState


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tcfgs, tsteps, tstate, tshard, twhisper, tserve, ttrain, \
        tree_leaves, value_and_grad
    import torch
    from repro_torch import configs as tcfgs
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models import whisper as twhisper
    from repro_torch.parallel import sharding as tshard
    from repro_torch.train import train_state as tstate
    from repro_torch.tree import tree_leaves, value_and_grad
    torch.set_num_threads(1)


ARCH = "whisper_large_v3"
ATOL = 2e-4
B, S = 2, 32                # decoder tokens; the smoke encoder_ctx is 64
S0, T_MAX, N_DECODE = 4, 12, 3
START_STEP = 1999           # the schedule's last warmup step: lr 3e-4


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


def _spec_shapes(tree):
    if isinstance(tree, dict):
        return {f"{k}/{p}": s for k in tree
                for p, s in _spec_shapes(tree[k]).items()}
    return {"": tuple(tree.shape)}


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's lowest backend
    optimization level."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _inputs(jcfg, seed):
    """Frames [B, encoder_ctx, D], tokens [B, S] and labels with a masked
    prefix, drawn with numpy."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, jcfg.encoder_ctx, jcfg.d_model)) \
        .astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[:, :3] = -1
    return frames, tokens, labels


def test_configs_and_specs_match_reference():
    """Both spellings resolve to the reference's config field for field;
    ``whisper_specs`` has the reference's leaves and shapes; the parameter
    count is the reference's."""
    for get_j, get_t in ((jget_config, tcfgs.get_config),
                         (jget_smoke, tcfgs.get_smoke_config)):
        for name in (ARCH, "whisper-large-v3"):
            jcfg, tcfg = get_j(name), get_t(name)
            jfields = {f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(jcfg) if f.name != "dtype"}
            tfields = {f.name: getattr(tcfg, f.name)
                       for f in dataclasses.fields(tcfg) if f.name != "dtype"}
            assert tfields == jfields
            assert str(tcfg.dtype).split(".")[-1] \
                == jnp.dtype(jcfg.dtype).name
            assert tcfg.is_encdec and tcfg.param_count() == jcfg.param_count()
            assert _spec_shapes(tsteps.model_specs(tcfg)) \
                == _spec_shapes(jwhisper.whisper_specs(jcfg))
    assert tcfgs.get_config(ARCH).param_count() == 1_534_602_240


def _adam_state(params, seed):
    """A mid-training AdamW state (step ``START_STEP``, random μ and ν) as
    numpy trees."""
    rng = np.random.default_rng(seed)
    mu = jax.tree_util.tree_map(
        lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    nu = jax.tree_util.tree_map(
        lambda a: (1e-6 * rng.random(a.shape) + 1e-8).astype(np.float32),
        params)
    return mu, nu


def _reference(jcfg, adam):
    """The reference on seeded weights and inputs, one compiled program:
    ``encode``, ``decoder_forward``, ``whisper_loss`` and its gradients
    (``"forward"``), and with ``adam`` (μ, ν) one ``make_train_step``
    step from that state (``"train"``: new state, metrics)."""
    params = np_spec_params(jwhisper.whisper_specs(jcfg), seed=71)
    frames, tokens, labels = _inputs(jcfg, seed=72)

    def forward(p, f, t, y):
        enc = jwhisper.encode(p, jcfg, f)
        hidden = jwhisper.decoder_forward(p, jcfg, t, enc)
        (loss, _), grads = jax.value_and_grad(
            lambda q: jwhisper.whisper_loss(q, jcfg, f, t, y),
            has_aux=True)(p)
        return enc, hidden, loss, grads

    batch = {"frames": frames, "tokens": tokens, "labels": labels}
    if adam is None:
        fn, args = forward, (params, frames, tokens, labels)
    else:
        state = JTrainState(
            params=params,
            opt_state=((), jopt.AdamState(
                step=jnp.asarray(START_STEP, jnp.int32), mu=adam[0],
                nu=adam[1])),
            step=jnp.asarray(START_STEP, jnp.int32))
        train_step = jmake_train_step(jcfg)

        def fn(st, b):
            return (forward(st.params, b["frames"], b["tokens"],
                            b["labels"]), train_step(st, b))
        args = (state, batch)
    t0 = time.perf_counter()
    out = jax.block_until_ready(_compiled(fn, *args)(*args))
    ref = {"params": params, "frames": frames, "tokens": tokens,
           "labels": labels, "seconds": time.perf_counter() - t0}
    if adam is None:
        return {**ref, "forward": out}
    return {**ref, "forward": out[0], "train": out[1], "adam": adam}


@functools.cache
def _reference_xla():
    """The plain plan's reference, shared by the gradient test and the
    train-step test."""
    jcfg = jget_smoke(ARCH)
    params = np_spec_params(jwhisper.whisper_specs(jcfg), seed=71)
    return _reference(jcfg, _adam_state(params, seed=76))


@pytest.mark.parametrize("impl", ["xla", "flash_interpret"])
def test_loss_and_grads_match_reference(impl, record_property):
    """``encode``, ``decoder_forward``, ``whisper_loss`` and every
    gradient; on the flash route, remat recomputes the same arithmetic
    (the gradients do not move by a bit)."""
    if impl == "xla":
        ref = _reference_xla()
    else:
        jcfg = dataclasses.replace(jget_smoke(ARCH), attn_impl=impl)
        ref = _reference(jcfg, None)
    record_property("reference_jit_compile_s", ref["seconds"])
    params, frames, tokens, labels = (ref[k] for k in (
        "params", "frames", "tokens", "labels"))
    enc, hidden, loss, grads = ref["forward"]

    tcfg = dataclasses.replace(tcfgs.get_smoke_config(ARCH), attn_impl=impl)
    tparams = tshard.lm_params_from_numpy(params, tcfg, device="cpu")
    tf, tt = torch.from_numpy(frames), torch.from_numpy(tokens)
    batch = {"frames": tf, "tokens": tt, "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        t_enc = twhisper.encode(tparams, tcfg, tf)
        t_hidden = twhisper.decoder_forward(tparams, tcfg, tt, t_enc)
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(enc), atol=ATOL)
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(hidden),
                               atol=ATOL)
    loss_fn = tsteps._loss_fn(tcfg)
    (t_loss, t_metrics), t_grads = value_and_grad(
        lambda p: loss_fn(p, batch), tparams, has_aux=True)
    np.testing.assert_allclose(float(t_loss), float(loss), atol=ATOL)
    assert sorted(t_metrics) == ["ce"]
    got, want = _flat(t_grads), _flat(grads)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=ATOL,
                                   err_msg=f"{impl} {path}")
    if impl == "flash_interpret":
        r_loss_fn = tsteps._loss_fn(dataclasses.replace(tcfg, remat=True))
        _, r_grads = value_and_grad(lambda p: r_loss_fn(p, batch), tparams,
                                    has_aux=True)
        for a, b in zip(tree_leaves(r_grads), tree_leaves(t_grads)):
            assert torch.equal(a, b)


def _kv(cache):
    return [np.array(cache.k, np.float32), np.array(cache.v, np.float32)]


def test_prefill_and_decode_match_reference(record_property):
    """``whisper_prefill`` through ``make_prefill_step`` (logits, the self
    caches padded to ``t_max``, the cross caches), then three decode
    steps through ``make_decode_step``: logits and caches; the port
    writes the self caches in place and never writes the cross caches."""
    jcfg = jget_smoke(ARCH)
    params = np_spec_params(jwhisper.whisper_specs(jcfg), seed=73)
    frames, tokens, _ = _inputs(jcfg, seed=74)
    prompt, steps = tokens[:, :S0], tokens[:, S0:S0 + N_DECODE]
    t0 = time.perf_counter()
    logits, caches, pos = _compiled(
        lambda p, f, t: jwhisper.whisper_prefill(p, jcfg, f, t, T_MAX),
        params, frames, prompt)(params, frames, prompt)
    decode = _compiled(lambda p, c, t, i: jwhisper.whisper_decode_step(
        p, jcfg, c, t, i), params, caches, steps[:, :1], np.int32(0))
    want = [(np.asarray(logits), _kv(caches["self"]), _kv(caches["cross"]))]
    for i in range(N_DECODE):
        step_logits, caches = decode(params, caches, steps[:, i:i + 1],
                                     np.int32(int(pos) + i))
        want.append((np.asarray(step_logits), _kv(caches["self"]),
                     _kv(caches["cross"])))
    record_property("reference_jit_compile_s", time.perf_counter() - t0)

    tcfg = tcfgs.get_smoke_config(ARCH)
    tparams = tshard.lm_params_from_numpy(params, tcfg, device="cpu")
    with torch.no_grad():
        tl, tc, tpos = tsteps.make_prefill_step(tcfg, T_MAX)(
            tparams, {"frames": torch.from_numpy(frames),
                      "tokens": torch.from_numpy(prompt)})
        assert tpos == S0 == int(pos)
        assert tc["self"].k.shape == (tcfg.n_layers, B, T_MAX, 64)
        assert tc["cross"].k.shape == (tcfg.n_layers, B,
                                       tcfg.encoder_ctx, 64)
        cross = [t.clone() for t in tc["cross"]]
        versions = [t._version for t in tc["cross"]]
        got = [(tl.numpy(), _kv(tc["self"]), _kv(tc["cross"]))]
        decode_t = tsteps.make_decode_step(tcfg)
        for i in range(N_DECODE):
            tl, same = decode_t(tparams, tc, torch.from_numpy(
                steps[:, i:i + 1]), tpos + i)
            assert same is tc                       # updated in place
            got.append((tl.numpy(), _kv(tc["self"]), _kv(tc["cross"])))
    assert [t._version for t in tc["cross"]] == versions
    assert all(torch.equal(a, b) for a, b in zip(tc["cross"], cross))
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("logits", "self.k", "self.v", "cross.k",
                               "cross.v"), (g[0], *g[1], *g[2]),
                              (w[0], *w[1], *w[2])):
            assert a.shape == b.shape, (i, name)
            np.testing.assert_allclose(a, b, atol=ATOL,
                                       err_msg=f"step {i}: {name}")


def test_train_step_matches_reference(record_property):
    """One ``make_train_step`` step from the same mid-training state
    (step 1999, random μ and ν), the state built by
    ``train_state_from_numpy`` from the reference's numpy trees: clipping,
    AdamW with decay, the parameters' change."""
    tcfg = tcfgs.get_smoke_config(ARCH)
    ref = _reference_xla()
    record_property("reference_jit_compile_s", ref["seconds"])
    params, frames, tokens, labels = (ref[k] for k in (
        "params", "frames", "tokens", "labels"))
    mu, nu = ref["adam"]
    jnew, jmetrics = ref["train"]

    tstate_ = tstate.train_state_from_numpy(params, tcfg, mu, nu,
                                            step=START_STEP, device="cpu")
    tnew, tmetrics = tsteps.make_train_step(tcfg)(
        tstate_, {"frames": torch.from_numpy(frames),
                  "tokens": torch.from_numpy(tokens),
                  "labels": torch.from_numpy(labels)})
    assert int(tnew.step) == START_STEP + 1 == int(jnew.step)
    assert int(tnew.opt_state[1].step) == int(jnew.opt_state[1].step)
    assert sorted(tmetrics) == sorted(jmetrics) == ["ce", "grad_norm",
                                                    "loss"]
    for k, v in jmetrics.items():
        assert abs(float(tmetrics[k]) - float(v)) \
            <= 1e-4 * max(abs(float(v)), 1e-30), k
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


def test_quantized_cache_raises_and_launchers_refuse():
    """``kv_cache_quant`` builds the reference's int8 decoder caches
    (``tests/test_torch_levers.py`` decodes on them); both launchers
    refuse an encoder-decoder config with the reference's
    ``SystemExit``."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config(ARCH),
                              kv_cache_quant=True)
    quant = twhisper.init_decoder_caches(cfg, 2, 8, device="cpu")
    for name, t in (("self", 8), ("cross", cfg.encoder_ctx)):
        c = quant[name]
        assert type(c).__name__ == "QuantKVCache"
        assert c.k.shape == c.v.shape == (2, 2, t, 64)
        assert c.k.dtype == c.v.dtype == torch.int8
        assert c.k_scale.shape == c.v_scale.shape == (2, 2, t,
                                                      cfg.n_kv_heads)
        assert c.k_scale.dtype == torch.float32
    with pytest.raises(SystemExit, match="enc-dec serving"):
        tserve.run(ARCH, smoke=True, device="cpu")
    with pytest.raises(SystemExit, match="enc-dec training"):
        ttrain.run(ARCH, smoke=True, device="cpu")
    caches = twhisper.init_decoder_caches(tcfgs.get_smoke_config(ARCH), 2, 8,
                                          device="cpu")
    assert caches["self"].k.shape == (2, 2, 8, 64)
    assert caches["cross"].v.shape == (2, 2, 64, 64)
