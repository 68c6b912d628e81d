"""Port parity for training the LM zoo's MoE and vision families:
``lm_loss`` and its gradients, ``moe_apply``'s VJP with dropped pairs,
the train step and the launcher of ``repro_torch`` against the JAX
reference, at the smoke configs of Qwen3-MoE, Llama-4 Scout, Jamba and
LLaVA (16 patch embeddings in front of the tokens, labels -1 over them),
in fp32.

Both packages get the same weights (numpy, from a seed, in the
reference's layout; ``tests/_torch_parity.np_spec_params``), tokens,
patches and optimizer state.  The reference runs jitted, compiled at
XLA's lowest backend optimization level, one program a config: the loss,
its metrics and gradients, and where a test reads it one
``make_train_step`` step (``grad_accum`` 2) from a mid-training state.
Its compile-and-run time is the junit property
``reference_jit_compile_s``.

Tolerances: the loss, its metrics and every parameter gradient within
atol 2e-4 (``tests/test_torch_lm.py``'s), on the plain plan (LLaVA at
every ``ce_chunk`` route: the full CE, chunks of 16 and a chunk of 32
that does not divide S - 1 = 48, which falls back to the full CE in both
packages) and for Qwen3-MoE also through the flash route (the
reference's Pallas kernels in interpret mode against the port's autograd
Function over the kernels' plain versions); Qwen3-MoE's gradients
rematerialized bit-identical to those without remat (the aux term
included).  ``moe_apply``'s VJP at ``capacity_factor`` 1.0 on random
tokens, where some pairs drop: each leaf within 1e-5 of its max, except
top-1's router (Scout), whose renormalized gate is exactly 1: its
derivative through the gate is rounding alone, so the router's gradient
is held absolutely, to 1e-5 of the layer's largest gradient entry; the
reference's smallest gap between the k-th and (k+1)-th router
probability must exceed 1e-4 (``tests/test_torch_moe.py``'s guard), so
both packages route the same way.  One train step (Qwen3-MoE with
Adafactor over its 4-D expert leaves, LLaVA with AdamW; both at
``grad_accum`` 2, so the patches split with the batch): params, the
optimizer's moments and the metrics within 1e-4 of each leaf's max, the
parameter change within 1e-3 of its max (``tests/test_torch_lm_train.py``'s).
"""

import dataclasses
import functools
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_spec_params
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.train import optimizer as jopt
from repro.train.train_state import TrainState as JTrainState


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tcfgs, tmoe, tsteps, tstate, ttrain, tshard, topt, \
        TModelConfig, tree_map, tree_leaves, value_and_grad
    import torch
    from repro_torch import configs as tcfgs
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models import moe as tmoe
    from repro_torch.models.config import ModelConfig as TModelConfig
    from repro_torch.parallel import sharding as tshard
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_state as tstate
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad
    torch.set_num_threads(1)


QWEN, SCOUT, JAMBA, LLAVA = ("qwen3_moe_235b_a22b", "llama4_scout_17b_a16e",
                             "jamba_1_5_large_398b", "llava_next_34b")
ATOL = 2e-4
B, S = 2, 33                # text tokens; LLaVA's 16 patches make 49
FLASH_S = 128               # one tile of the reference's flash kernels
LLAVA_CE = (0, 16, 32)      # S - 1 = 48: 16 divides it, 32 falls back
START_STEP = 1999           # the schedule's last warmup step
VJP_RTOL = 1e-5
MIN_GAP = 1e-4
# the train step's configs: Qwen3-MoE with Adafactor, both at grad_accum 2
TRAIN = {QWEN: dict(optimizer="adafactor", grad_accum=2),
         LLAVA: dict(grad_accum=2)}


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


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's lowest backend
    optimization level."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "dtype"}
    return TModelConfig(**fields, dtype=torch.float32)


def _inputs(jcfg, seed, n_tokens=S, batch=B):
    """Tokens, labels (a masked prefix: the patches' for a vision config,
    else 3 tokens) and patches (None without a vision frontend)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (batch, n_tokens)).astype(np.int32)
    if jcfg.frontend != "vision":
        labels = tokens.copy()
        labels[:, :3] = -1
        return tokens, labels, None
    P = jcfg.frontend_tokens
    patches = (0.02 * rng.standard_normal((batch, P, jcfg.d_model))) \
        .astype(np.float32)
    labels = np.concatenate([np.full((batch, P), -1, np.int32), tokens], 1)
    return tokens, labels, patches


def _opt_state(jcfg, params, seed):
    """A mid-training optimizer state as numpy trees: AdamW's μ, ν or
    Adafactor's vr, vc (each leaf's row and column moments)."""
    rng = np.random.default_rng(seed)
    pos = lambda a: (1e-6 * rng.random(a.shape) + 1e-8).astype(np.float32)
    if jcfg.optimizer == "adafactor":
        zero = jopt.adafactor().init(params)
        return {"vr": jax.tree.map(pos, zero.vr),
                "vc": jax.tree.map(pos, zero.vc)}
    return {"mu": jax.tree.map(lambda a: (1e-3 * rng.standard_normal(
        a.shape)).astype(np.float32), params),
            "nu": jax.tree.map(pos, params)}


@functools.cache
def _reference(arch: str, impl: str = "xla") -> dict:
    """One compiled program: ``lm_loss``'s value, metrics and gradients
    (for LLaVA at each of ``LLAVA_CE``), and for an arch of ``TRAIN`` one
    train step from ``_opt_state``."""
    jcfg = dataclasses.replace(jget_smoke(arch), attn_impl=impl,
                               **TRAIN.get(arch, {}))
    params = np_spec_params(jlm.lm_specs(jcfg), seed=81)
    n, batch = (FLASH_S, 1) if impl != "xla" else (S, B)
    tokens, labels, patches = _inputs(jcfg, 82, n, batch)
    chunks = LLAVA_CE if arch == LLAVA else (jcfg.ce_chunk,)

    def grads(p, t, y, e):
        return [jax.value_and_grad(
            lambda q: jlm.lm_loss(q, dataclasses.replace(jcfg, ce_chunk=c),
                                  t, y, e), has_aux=True)(p)
            for c in chunks]

    ref = {"jcfg": jcfg, "params": params, "tokens": tokens,
           "labels": labels, "patches": patches}
    t0 = time.perf_counter()
    if arch in TRAIN and impl == "xla":
        opt = _opt_state(jcfg, params, seed=83)
        if jcfg.optimizer == "adafactor":
            inner = jopt.AdafactorState(
                step=jnp.asarray(START_STEP, jnp.int32), **opt)
        else:
            inner = jopt.AdamState(step=jnp.asarray(START_STEP, jnp.int32),
                                   **opt)
        state = JTrainState(params=params, opt_state=((), inner),
                            step=jnp.asarray(START_STEP, jnp.int32))
        batch_ = {"tokens": tokens, "labels": labels}
        if patches is not None:
            batch_["patches"] = patches
        step = jmake_train_step(jcfg)

        def fn(st, b):
            return (grads(st.params, b["tokens"], b["labels"],
                          b.get("patches")), step(st, b))
        out = jax.block_until_ready(_compiled(fn, state, batch_)(state,
                                                                 batch_))
        ref.update(grads=out[0], train=out[1], opt=opt)
    else:
        out = jax.block_until_ready(_compiled(
            grads, params, tokens, labels, patches)(params, tokens, labels,
                                                    patches))
        ref.update(grads=out)
    ref["seconds"] = time.perf_counter() - t0
    return ref


def _torch_batch(ref) -> dict:
    batch = {"tokens": torch.from_numpy(ref["tokens"]),
             "labels": torch.from_numpy(ref["labels"])}
    if ref["patches"] is not None:
        batch["patches"] = torch.from_numpy(ref["patches"])
    return batch


LOSS_CASES = [(QWEN, "xla"), (SCOUT, "xla"), (JAMBA, "xla"), (LLAVA, "xla"),
              (QWEN, "flash_interpret")]


@pytest.mark.parametrize("arch,impl", LOSS_CASES,
                         ids=[f"{a}-{i}" for a, i in LOSS_CASES])
def test_loss_and_grads_match_reference(arch, impl, record_property):
    """``lm_loss`` through ``launch.steps._loss_fn`` (the vision branch
    passes ``batch["patches"]``): the loss, ``ce``, ``aux``, ``tokens``
    and every parameter gradient."""
    ref = _reference(arch, impl)
    record_property("reference_jit_compile_s", ref["seconds"])
    jcfg = ref["jcfg"]
    tparams = tshard.lm_params_from_numpy(ref["params"], _port_cfg(jcfg),
                                          device="cpu")
    batch = _torch_batch(ref)
    chunks = LLAVA_CE if arch == LLAVA else (jcfg.ce_chunk,)
    for c, ((loss, metrics), grads) in zip(chunks, ref["grads"]):
        tcfg = dataclasses.replace(_port_cfg(jcfg), ce_chunk=c)
        loss_fn = tsteps._loss_fn(tcfg)
        (t_loss, t_metrics), t_grads = value_and_grad(
            lambda p: loss_fn(p, batch), tparams, has_aux=True)
        np.testing.assert_allclose(float(t_loss), float(loss), atol=ATOL)
        for k in ("ce", "aux", "tokens"):
            np.testing.assert_allclose(float(t_metrics[k]),
                                       float(metrics[k]), atol=ATOL,
                                       err_msg=f"ce_chunk {c}: {k}")
        if arch == LLAVA:       # the text tokens alone: S a row
            assert float(t_metrics["tokens"]) == B * S
        got, want = _flat(t_grads), _flat(grads)
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], atol=ATOL,
                                       err_msg=f"ce_chunk {c}: {path}")
    if arch == QWEN and impl == "xla":
        # the periods rematerialized: the same arithmetic, the summed aux
        # term's gradient included
        r_loss_fn = tsteps._loss_fn(dataclasses.replace(tcfg, remat=True))
        _, r_grads = value_and_grad(lambda p: r_loss_fn(p, batch), tparams,
                                    has_aux=True)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(r_grads), tree_leaves(t_grads)))


_VJP: dict = {}


def _vjp_reference(arch: str) -> dict:
    """``moe_apply``'s VJP in the reference at ``capacity_factor`` 1.0 on
    random tokens: the gradients of ``sum(y · ct) + 3 · aux`` by the
    params and x, and the sorted router probabilities."""
    if arch in _VJP:
        return _VJP[arch]
    jcfg = dataclasses.replace(jget_smoke(arch), capacity_factor=1.0)
    rng = np.random.default_rng(91)
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    params = np_spec_params(jmoe.moe_specs(jcfg), seed=92)

    def fn(p, x):
        def f(p, x):
            y, aux = jmoe.moe_apply(p, jcfg, x)
            return jnp.sum(y * ct) + 3.0 * aux
        logits = jnp.einsum("bsd,de->bse", x, p["router"],
                            preferred_element_type=jnp.float32)
        probs = jnp.sort(jax.nn.softmax(logits, -1), axis=-1)[..., ::-1]
        return jax.grad(f, argnums=(0, 1))(p, x), probs

    t0 = time.perf_counter()
    (gp, gx), probs = jax.block_until_ready(
        _compiled(fn, params, x)(params, x))
    _VJP[arch] = {"jcfg": jcfg, "x": x, "ct": ct, "params": params,
                  "gp": gp, "gx": np.asarray(gx), "probs": np.asarray(probs),
                  "seconds": time.perf_counter() - t0}
    return _VJP[arch]


@pytest.mark.parametrize("arch", [QWEN, SCOUT])
def test_moe_vjp_with_drops_matches_reference(arch, record_property):
    """``moe_apply``'s gradients by every parameter (router, experts,
    the shared expert) and by x, with pairs dropped: a dropped pair's
    zero-weighted row adds to slot C-1's gradient and never overwrites
    it."""
    ref = _vjp_reference(arch)
    record_property("reference_jit_compile_s", ref["seconds"])
    cfg = _port_cfg(ref["jcfg"])
    k = cfg.top_k
    gap = ref["probs"][..., k - 1] - ref["probs"][..., k]
    assert float(gap.min()) > MIN_GAP, float(gap.min())
    params = tree_map(lambda a: torch.from_numpy(np.array(a)), ref["params"])
    x, ct = torch.from_numpy(ref["x"]), torch.from_numpy(ref["ct"])
    keep = tmoe.route(params, cfg, x).keep
    assert 0 < int((~keep).sum()) < keep.numel()

    def f(both):
        y, aux = tmoe.moe_apply(both[0], cfg, both[1])
        return (y * ct).sum() + 3.0 * aux

    _, (gp, gx) = value_and_grad(f, (params, x))
    got, want = _flat(gp), _flat(ref["gp"])
    got["x"], want["x"] = gx.numpy(), ref["gx"]
    assert sorted(got) == sorted(want)
    layer_max = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        if path == "/router" and k == 1:
            assert err <= VJP_RTOL * layer_max, (path, err, layer_max)
        else:
            assert err <= VJP_RTOL * float(np.abs(w).max()), (path, err)


@pytest.mark.parametrize("arch", [QWEN, LLAVA])
def test_train_step_matches_reference(arch, record_property):
    """One ``make_train_step`` step at ``grad_accum`` 2 from the same
    mid-training state, built by ``train_state_from_numpy``: Qwen3-MoE's
    Adafactor over its 4-D expert leaves ``[periods, E, D, F]`` (row and
    column moments), LLaVA's AdamW with its patches split with the
    batch."""
    ref = _reference(arch, "xla")
    record_property("reference_jit_compile_s", ref["seconds"])
    jcfg, params, opt = ref["jcfg"], ref["params"], ref["opt"]
    jnew, jmetrics = ref["train"]
    tcfg = _port_cfg(jcfg)
    state = tstate.train_state_from_numpy(
        params, tcfg, step=START_STEP, device="cpu",
        **{k: jax.tree.map(np.asarray, v) for k, v in opt.items()})
    inner = state.opt_state[1]
    assert isinstance(inner, topt.AdafactorState if arch == QWEN
                      else topt.AdamState)
    if arch == QWEN:
        w_up = inner.vr["blocks"][0]["ffn"]["w_up"]
        assert state.params["blocks"][0]["ffn"]["w_up"].dim() == 4
        assert w_up.shape == jnew.opt_state[1].vr["blocks"][0]["ffn"][
            "w_up"].shape
    tnew, tmetrics = tsteps.make_train_step(tcfg)(state, _torch_batch(ref))
    assert int(tnew.step) == START_STEP + 1 == int(jnew.step)
    assert int(tnew.opt_state[1].step) == int(jnew.opt_state[1].step)
    assert sorted(tmetrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        assert abs(float(tmetrics[k]) - float(v)) \
            <= 1e-4 * max(abs(float(v)), 1e-30), k
    old = _flat(params)
    moments = ("vr", "vc") if arch == QWEN else ("mu", "nu")
    for name in ("params",) + moments:
        got = _flat(tnew.params if name == "params"
                    else getattr(tnew.opt_state[1], name))
        want = _flat(jnew.params if name == "params"
                     else getattr(jnew.opt_state[1], name))
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


@pytest.mark.parametrize("arch", [QWEN, LLAVA])
def test_launcher_trains_on_the_cpu(arch):
    """``launch.train.run`` at the smoke config: two steps with finite
    losses; the params stay in the reference's layout.  LLaVA's batch is
    the reference launcher's: zero patches in front, labels -1 over
    them."""
    res = ttrain.run(arch, steps=2, batch=2, seq_len=16, smoke=True,
                     device="cpu", log_every=1)
    assert len(res.losses) == 2 and int(res.state.step) == 2
    assert all(math.isfinite(x) for x in res.losses + res.grad_norms)
    cfg = tcfgs.get_smoke_config(arch)
    want = {p: tuple(s.shape) for p, s in _flat(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32),
        jlm.lm_specs(jget_smoke(arch)),
        is_leaf=lambda s: hasattr(s, "shape"))).items()}
    assert {p: a.shape for p, a in _flat(res.state.params).items()} == want
    if arch == LLAVA:
        tokens = torch.zeros((2, 16), dtype=torch.int32)
        b = ttrain.vision_batch(cfg, {"tokens": tokens, "labels": tokens})
        assert b["patches"].shape == (2, cfg.frontend_tokens, cfg.d_model)
        assert b["patches"].dtype == cfg.dtype and not b["patches"].any()
        assert b["labels"].dtype == torch.int32
        assert b["labels"].shape == (2, cfg.frontend_tokens + 16)
        assert bool((b["labels"][:, :cfg.frontend_tokens] == -1).all())


@pytest.mark.parametrize("arch", [QWEN, SCOUT, JAMBA, LLAVA])
def test_train_state_builds_for_every_zoo_config(arch):
    """``init_train_state`` at the smoke config under both optimizers:
    the reference's state structure and shapes, Adafactor's factored
    moments over the 4-D expert leaves included."""
    jcfg, tcfg = jget_smoke(arch), tcfgs.get_smoke_config(arch)
    specs = tsteps.model_specs(tcfg)
    jparams = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                           jlm.lm_specs(jcfg),
                           is_leaf=lambda s: hasattr(s, "shape"))
    for name in ("adamw", "adafactor"):
        cfg = dataclasses.replace(tcfg, optimizer=name)
        st = tstate.init_train_state(torch.Generator().manual_seed(0), cfg,
                                     specs, tstate.make_tx(cfg),
                                     device="cpu")
        inner = st.opt_state[1]
        if name == "adafactor":
            want = jopt.adafactor().init(jparams)
            for f in ("vr", "vc"):
                assert {p: a.shape for p, a in _flat(
                    getattr(inner, f)).items()} == {
                    p: a.shape for p, a in _flat(getattr(want, f)).items()}
        else:
            assert {p: a.shape for p, a in _flat(inner.mu).items()} == {
                p: a.shape for p, a in _flat(jparams).items()}
