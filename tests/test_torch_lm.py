"""Port parity for the LM serving slice as a model: configs, params,
``forward``, ``prefill`` and ``decode_step`` of ``repro_torch.models.lm``
against the JAX reference, at the smoke configs ``phi4-mini-smoke`` and
``mamba2-smoke`` in fp32.

Both packages get the same weights (numpy, from a seed, in the
reference's layout; ``tests/_torch_parity.np_lm_params``) and tokens.
The reference runs its kernels: ``attn_impl="flash_interpret"`` and
``ssd_impl="kernel_interpret"`` (the Pallas kernels in interpret mode),
computed once per config.  The port runs each of its plans against that
one reference: ``"flash"`` (the kernel's plain version on the CPU) and
``"xla"`` (full, and chunked at ``attn_chunk`` 16) for attention,
``"kernel"`` and ``"xla"`` (the chunked scan) for SSD.  Hidden states,
logits and every cache leaf must agree within 2e-4 — the tighter of
``tests/test_models.py``'s two (5e-3 flash vs xla, 2e-4 SSD kernel vs
xla) — after prefill and after each of 4 decode steps (the port updates
its caches in place).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_lm_params
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.parallel.sharding import ParamSpec as JParamSpec


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tcfgs, tlm, tshard, tsteps
    import torch
    from repro_torch import configs as tcfgs
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm as tlm
    from repro_torch.parallel import sharding as tshard
    torch.set_num_threads(1)


ARCHS = ("phi4_mini_3_8b", "mamba2_1_3b", "qwen3_moe_235b_a22b",
         "llama4_scout_17b_a16e", "jamba_1_5_large_398b", "starcoder2_3b",
         "starcoder2_7b", "llava_next_34b", "nemotron_4_340b")
JAX_IMPL = {"phi4_mini_3_8b": {"attn_impl": "flash_interpret"},
            "mamba2_1_3b": {"ssd_impl": "kernel_interpret"}}
PORT_IMPLS = [("phi4_mini_3_8b", {"attn_impl": "flash"}),
              ("phi4_mini_3_8b", {"attn_impl": "xla"}),
              ("phi4_mini_3_8b", {"attn_impl": "xla", "attn_chunk": 16}),
              ("mamba2_1_3b", {"ssd_impl": "kernel"}),
              ("mamba2_1_3b", {"ssd_impl": "xla"})]
B, S, T_MAX, N_DECODE = 2, 32, 40, 4
ATOL = 2e-4


def _np(x):
    return np.asarray(x, np.float32)


def _cache_leaves(caches):
    """(name, array) per cache field, pattern position by position."""
    return [(f"{i}.{f}", getattr(c, f)) for i, c in enumerate(caches)
            for f in c._fields]


_REFERENCE: dict = {}


def _reference(arch: str) -> dict:
    """The reference's forward, prefill and decode steps, computed once
    per config (jitted: a compile per program is cheaper than eager
    ops)."""
    if arch in _REFERENCE:
        return _REFERENCE[arch]
    t0 = time.perf_counter()
    jcfg = dataclasses.replace(jget_smoke(arch), **JAX_IMPL[arch])
    params = np_lm_params(jcfg, seed=7)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (N_DECODE, B, 1)).astype(np.int32)
    # forward and prefill in one program: one compile, shared layers
    hidden, logits, caches = jax.jit(
        lambda p, t: (jlm.forward(p, jcfg, t)[0],
                      *jlm.prefill(p, jcfg, t, t_max=T_MAX)[:2]))(
        params, tokens)
    pos = S
    decode = jax.jit(lambda p, c, t, i: jlm.decode_step(p, jcfg, c, t, i))
    out = {"arch": arch, "params": params, "tokens": tokens, "steps": steps,
           "hidden": _np(hidden), "prefill_logits": _np(logits), "pos": pos,
           "prefill_caches": [(n, _np(a)) for n, a in _cache_leaves(caches)],
           "decode": []}
    for i in range(N_DECODE):
        logits, caches = decode(params, caches, steps[i], pos + i)
        out["decode"].append(
            (_np(logits), [(n, _np(a)) for n, a in _cache_leaves(caches)]))
    out["reference_s"] = time.perf_counter() - t0
    _REFERENCE[arch] = out
    return out


def _port(reference, impl):
    cfg = dataclasses.replace(tcfgs.get_smoke_config(reference["arch"]),
                              **impl)
    return cfg, tshard.lm_params_from_numpy(reference["params"], cfg,
                                            device="cpu")


def _assert_caches(got, want, where):
    got = _cache_leaves(got)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, (where, name)
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL,
                                   err_msg=f"{where}: {name}")


@pytest.mark.parametrize("arch,impl", PORT_IMPLS,
                         ids=[f"{a}-{'-'.join(map(str, i.values()))}"
                              for a, i in PORT_IMPLS])
def test_forward_prefill_decode_match_reference(arch, impl, record_property):
    reference = _reference(arch)
    # the reference's two compiles and its run, paid by the first case
    record_property("reference_jit_compile_s", reference["reference_s"])
    cfg, params = _port(reference, impl)
    tokens = torch.from_numpy(reference["tokens"]).long()
    hidden, aux = tlm.forward(params, cfg, tokens)
    np.testing.assert_allclose(hidden.numpy(), reference["hidden"],
                               atol=ATOL)
    assert float(aux) == 0.0
    logits, caches, pos = tlm.prefill(params, cfg, tokens, t_max=T_MAX)
    assert pos == reference["pos"]
    np.testing.assert_allclose(logits.numpy(), reference["prefill_logits"],
                               atol=ATOL)
    np.testing.assert_allclose(
        tlm.lm_logits(params, cfg, hidden)[:, -1].numpy(),
        reference["prefill_logits"], atol=ATOL)
    _assert_caches(caches, reference["prefill_caches"], "prefill")
    for i, (want_logits, want_caches) in enumerate(reference["decode"]):
        token = torch.from_numpy(reference["steps"][i]).long()
        logits, same = tlm.decode_step(params, cfg, caches, token, pos + i)
        assert same is caches                       # updated in place
        np.testing.assert_allclose(logits.numpy(), want_logits, atol=ATOL,
                                   err_msg=f"decode step {i}")
        _assert_caches(caches, want_caches, f"decode step {i}")


def _spec_shapes(tree):
    """{path: shape} of a specs or params tree of either package."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": s for k in tree
                for p, s in _spec_shapes(tree[k]).items()}
    if isinstance(tree, list):
        return {f"{i}/{p}": s for i, t in enumerate(tree)
                for p, s in _spec_shapes(t).items()}
    return {"": tuple(tree.shape)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_param_counts_and_specs_match_reference(arch):
    for get_j, get_t in ((jget_config, tcfgs.get_config),
                         (jget_smoke, tcfgs.get_smoke_config)):
        jcfg, tcfg = get_j(arch), get_t(arch)
        jfields = {f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(jcfg) if f.name != "dtype"}
        tfields = {f.name: getattr(tcfg, f.name)
                   for f in dataclasses.fields(tcfg) if f.name != "dtype"}
        assert tfields == jfields
        assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
        assert (tcfg.head_dim, tcfg.n_periods, tcfg.ssm_inner,
                tcfg.ssm_heads) == (jcfg.head_dim, jcfg.n_periods,
                                    jcfg.ssm_inner, jcfg.ssm_heads)
        jspecs, tspecs = jlm.lm_specs(jcfg), tsteps.model_specs(tcfg)
        assert _spec_shapes(tspecs) == _spec_shapes(jspecs)
        assert isinstance(jspecs["embed"], JParamSpec)
    # the smoke config materialized: every leaf has the reference's shape
    tcfg = tcfgs.get_smoke_config(arch)
    params = tshard.init_params(tsteps.model_specs(tcfg),
                                torch.Generator().manual_seed(0),
                                tcfg.dtype, device="cpu")
    assert _spec_shapes(params) == _spec_shapes(jlm.lm_specs(jget_smoke(arch)))
    norm = params["final_norm"]["scale"]
    assert torch.equal(norm, torch.ones_like(norm))
    assert 0.015 < float(params["embed"].std()) < 0.025


def test_unported_architectures_and_layouts_raise():
    with pytest.raises(NotImplementedError, match="A7"):
        tcfgs.get_config("whisper_large_v3")
    with pytest.raises(NotImplementedError, match="A7"):
        tcfgs.get_smoke_config("whisper-large-v3")
    # Nemotron-4 resolves now, under both spellings, to the reference's
    for get, jget in ((tcfgs.get_config, jget_config),
                      (tcfgs.get_smoke_config, jget_smoke)):
        for name in ("nemotron_4_340b", "nemotron-4-340b"):
            got, want = get(name), jget(name)
            assert (got.name, got.head_dim, got.optimizer) \
                == (want.name, want.head_dim, want.optimizer)
    cfg = tcfgs.get_smoke_config("phi4_mini_3_8b")
    with pytest.raises(NotImplementedError, match="A7"):
        tlm.init_caches(dataclasses.replace(cfg, kv_cache_quant=True), 1, 8)
    encdec = dataclasses.replace(cfg, encoder_layers=2)
    for build in (tsteps.model_specs, tsteps.make_prefill_step,
                  tsteps.make_decode_step):
        with pytest.raises(NotImplementedError, match="A7"):
            build(encdec)
    bad = np_lm_params(jget_smoke("phi4_mini_3_8b"), seed=0)
    bad["embed"] = bad["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        tshard.lm_params_from_numpy(bad, cfg, device="cpu")


def test_cache_constructors_default_to_the_card(monkeypatch):
    """``init_caches`` and ``init_mamba_cache`` resolve ``device=None`` to
    the card like every other entry point: without one they raise instead
    of allocating on the CPU; ``device="cpu"`` is the explicit opt-in."""
    from repro_torch.models import ssd as tssd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    phi4 = tcfgs.get_smoke_config("phi4_mini_3_8b")
    mamba = tcfgs.get_smoke_config("mamba2_1_3b")
    for cfg in (phi4, mamba):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlm.init_caches(cfg, 1, 8)
        caches = tlm.init_caches(cfg, 1, 8, device="cpu")
        assert caches[0][0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tssd.init_mamba_cache(mamba, 1)
    assert tssd.init_mamba_cache(mamba, 1, device="cpu").state.device.type \
        == "cpu"
