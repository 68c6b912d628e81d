"""Port parity for the LM zoo's decoder-only families: ``forward``,
``prefill`` and ``decode_step`` of ``repro_torch.models.lm`` against the
JAX reference at the smoke configs of Qwen3-MoE, Llama-4 Scout (MoE),
Jamba (the hybrid), StarCoder2-3B (gelu, layernorm) and LLaVA (with 16
random patch embeddings in front of the tokens), in fp32.

Both packages get the same weights (numpy, from a seed, in the
reference's layout; ``tests/_torch_parity.np_lm_params``), tokens and
patches.  The reference runs its plain plans (``attn_impl`` and
``ssd_impl`` ``"xla"``; its kernels are held to the port's in
``tests/test_torch_lm_kernels.py``), jitted once per config.  The port
runs both of its plans against that one reference: the kernels' route
(``"flash"`` / ``"kernel"``, their plain versions on the CPU) and
``"xla"``, through ``launch.steps.make_prefill_step`` and
``make_decode_step``.  Hidden states, the MoE aux term, logits and every
cache leaf must agree within 2e-4 (``tests/test_torch_lm.py``'s limit)
after prefill and after each of 2 decode steps.  Then the reference's
own decode-vs-forward check (``tests/test_models.py:92-104``) on the port
at its 3e-3 (the six full configs' parameter counts and spec shapes are
``tests/test_torch_lm.py``'s), the expert leaves' initializers, the
serving launcher on two new ids, and MoE training refused.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest

from _torch_parity import np_lm_params
from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file."""
    global torch, tcfgs, tlm, tshard, tsteps
    import torch
    from repro_torch import configs as tcfgs
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm as tlm
    from repro_torch.parallel import sharding as tshard
    torch.set_num_threads(1)


ARCHS = ("qwen3_moe_235b_a22b", "llama4_scout_17b_a16e",
         "jamba_1_5_large_398b", "starcoder2_3b", "llava_next_34b")
PLANS = {"kernel": {"attn_impl": "flash", "ssd_impl": "kernel"},
         "xla": {"attn_impl": "xla", "ssd_impl": "xla"}}
B, S, N_DECODE = 2, 32, 2
ATOL = 2e-4
DECODE_VS_FORWARD_ATOL = 3e-3


def _np(x):
    return np.asarray(x, np.float32)


def _cache_leaves(caches):
    """(name, array) per cache field, pattern position by position."""
    return [(f"{i}.{f}", getattr(c, f)) for i, c in enumerate(caches)
            for f in c._fields]


def _prefix(cfg) -> int:
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


_REFERENCE: dict = {}


def _reference(arch: str) -> dict:
    """The reference's forward, prefill and decode steps, computed once
    per config (forward and prefill in one jitted program, the decode
    step in another)."""
    if arch in _REFERENCE:
        return _REFERENCE[arch]
    t0 = time.perf_counter()
    jcfg = jget_smoke(arch)
    params = np_lm_params(jcfg, seed=7)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (N_DECODE, B, 1)).astype(np.int32)
    patches = (rng.standard_normal((B, _prefix(jcfg), jcfg.d_model)) * 0.02
               ).astype(np.float32) if _prefix(jcfg) else None
    t_max = _prefix(jcfg) + S + N_DECODE + 4
    (hidden, aux), (logits, caches, pos) = jax.jit(
        lambda p, t, e: (jlm.forward(p, jcfg, t, e),
                         jlm.prefill(p, jcfg, t, e, t_max=t_max)))(
        params, tokens, patches)
    decode = jax.jit(lambda p, c, t, i: jlm.decode_step(p, jcfg, c, t, i))
    out = {"arch": arch, "params": params, "tokens": tokens, "steps": steps,
           "patches": patches, "t_max": t_max, "hidden": _np(hidden),
           "aux": float(aux), "prefill_logits": _np(logits), "pos": int(pos),
           "prefill_caches": [(n, _np(a)) for n, a in _cache_leaves(caches)],
           "decode": []}
    for i in range(N_DECODE):
        logits, caches = decode(params, caches, steps[i], out["pos"] + i)
        out["decode"].append(
            (_np(logits), [(n, _np(a)) for n, a in _cache_leaves(caches)]))
    out["reference_s"] = time.perf_counter() - t0
    _REFERENCE[arch] = out
    return out


def _assert_caches(got, want, where):
    got = _cache_leaves(got)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, (where, name)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=f"{where}: {name}")


def _batch(reference) -> dict:
    batch = {"tokens": torch.from_numpy(reference["tokens"]).long()}
    if reference["patches"] is not None:
        batch["patches"] = torch.from_numpy(reference["patches"])
    return batch


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, plan, record_property):
    reference = _reference(arch)
    record_property("reference_jit_compile_s", reference["reference_s"])
    cfg = dataclasses.replace(tcfgs.get_smoke_config(arch), **PLANS[plan])
    params = tshard.lm_params_from_numpy(reference["params"], cfg,
                                         device="cpu")
    batch = _batch(reference)
    hidden, aux = tlm.forward(params, cfg, batch["tokens"],
                              batch.get("patches"))
    np.testing.assert_allclose(hidden.numpy(), reference["hidden"], rtol=0,
                               atol=ATOL)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - reference["aux"]) <= ATOL
    if any(f == "moe" for _, f in cfg.pattern):
        assert float(aux) > 0
    logits, caches, pos = tsteps.make_prefill_step(cfg, reference["t_max"])(
        params, batch)
    assert pos == reference["pos"] == _prefix(cfg) + S
    np.testing.assert_allclose(logits.numpy(), reference["prefill_logits"],
                               rtol=0, atol=ATOL)
    _assert_caches(caches, reference["prefill_caches"], "prefill")
    decode = tsteps.make_decode_step(cfg)
    for i, (want_logits, want_caches) in enumerate(reference["decode"]):
        token = torch.from_numpy(reference["steps"][i]).long()
        logits, same = decode(params, caches, token, pos + i)
        assert same is caches                       # updated in place
        np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                                   atol=ATOL, err_msg=f"decode step {i}")
        _assert_caches(caches, want_caches, f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """``tests/test_models.py::test_decode_matches_forward`` on the port:
    the forward's last-position logits equal a prefill of all but the
    last token followed by one decode step of it."""
    reference = _reference(arch)
    cfg = dataclasses.replace(tcfgs.get_smoke_config(arch),
                              **PLANS["kernel"])
    params = tshard.lm_params_from_numpy(reference["params"], cfg,
                                         device="cpu")
    batch = _batch(reference)
    tokens, extra = batch["tokens"], batch.get("patches")
    with torch.no_grad():
        hidden, _ = tlm.forward(params, cfg, tokens, extra)
        logits_tf = tlm.lm_logits(params, cfg, hidden[:, -1])
        _, caches, pos = tlm.prefill(params, cfg, tokens[:, :-1], extra,
                                     t_max=_prefix(cfg) + S + 4)
        dl, _ = tlm.decode_step(params, cfg, caches, tokens[:, -1:], pos)
    np.testing.assert_allclose(logits_tf.numpy(), dl.numpy(), rtol=0,
                               atol=DECODE_VS_FORWARD_ATOL)


def test_init_params_draws_the_expert_leaves_at_their_fan_in():
    """``init_params`` carries the MoE leaves (the router, the stacked
    expert weights, Llama-4's nested shared expert), each drawn at the
    fan-in of its ``shape[-2]``, as the reference's ``_init_leaf``."""
    cfg = tcfgs.get_smoke_config("llama4_scout_17b_a16e")
    params = tshard.init_params(tsteps.model_specs(cfg),
                                torch.Generator().manual_seed(0),
                                cfg.dtype, device="cpu")
    ffn = params["blocks"][0]["ffn"]
    n, E, D, F = cfg.n_periods, cfg.n_experts, cfg.d_model, cfg.d_ff_moe
    want = {"router": ((n, D, E), D), "w_up": ((n, E, D, F), D),
            "w_gate": ((n, E, D, F), D), "w_down": ((n, E, F, D), F)}
    for name, (shape, fan_in) in want.items():
        leaf = ffn[name]
        assert tuple(leaf.shape) == shape, name
        assert abs(float(leaf.std()) * fan_in ** 0.5 - 1) < 0.1, name
    assert sorted(ffn["shared"]) == ["w_down", "w_gate", "w_up"]
    assert tuple(ffn["shared"]["w_down"].shape) == (n, F, D)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b",
                                  "jamba_1_5_large_398b"])
def test_serve_launcher_runs_the_new_families(arch):
    from repro_torch.launch import serve
    res = serve.run(arch, n_requests=4, batch=2, prompt_len=4, max_new=6,
                    smoke=True, device="cpu")
    vocab = tcfgs.get_smoke_config(arch).vocab
    assert len(res.completed) == 4
    assert all(len(r.tokens) == 6 and all(0 <= t < vocab for t in r.tokens)
               for r in res.completed)


def test_moe_training_raises_naming_a7():
    """MoE training is not ported yet: the train step and the launcher
    refuse it before building any state."""
    from repro_torch.launch import train
    cfg = tcfgs.get_smoke_config("qwen3_moe_235b_a22b")
    assert tsteps.untrainable(cfg) == "training MoE blocks"
    assert tsteps.untrainable(tcfgs.get_smoke_config("starcoder2_3b")) is None
    with pytest.raises(NotImplementedError, match="A7"):
        tsteps.make_train_step(cfg)
    with pytest.raises(NotImplementedError, match="A7"):
        train.run("llama4_scout_17b_a16e", steps=1, smoke=True, device="cpu")
