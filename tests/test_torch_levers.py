"""Port parity for the single-device levers: the int8 KV cache
(``kv_cache_quant``) and the ``"dots"`` remat policy, against the JAX
reference at the smoke configs in fp32.

Both packages get the same weights (numpy, from a seed, in the
reference's layout; ``tests/_torch_parity.np_spec_params``) and tokens.
The reference's decode steps are jitted once per config, compiled at
XLA's lowest backend optimization level; their compile-and-run time is
the junit property ``reference_jit_compile_s``.

The int8 cache: token by token from ``init_caches`` (Phi-4-mini, and
Qwen3-MoE with an attention layer after a MoE block) and from Whisper's
``init_decoder_caches`` (self and cross caches int8), the logits of every
step within atol 2e-4 (``tests/test_torch_lm.py``'s); the int8 leaves
equal, except an element whose unrounded value lies within 1e-6 of the
int8 range (1.27e-4) of a rounding tie, which may land one step apart
(fp32 sums in another order move that value by ~1e-5); the scales within
1e-6 relative.  Then the reference's own test
(``tests/test_models.py:234-250``) on the port: the int8 path's logits
within 5% (max-abs relative) of the bf16 cache's; and ``serve_loop`` on
an int8 config against the reference's: the same steps, requests and
tokens up to the first one whose logits' top-2 margin is under 2e-4.

``"dots"``: the loss's gradients ``torch.equal`` under ``"dots"``,
``"full"`` and no remat (Phi-4-mini on the plain plan and through the
flash autograd Function, Qwen3-MoE); a dispatch-mode count of the
backward's ``aten.mm``: ``"dots"`` launches none beyond the gradients'
own (the no-remat backward's), ``"full"`` recomputes the periods'
products; the flash Function's forward runs again in the backward under
both.
"""

import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_spec_params
from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.models import whisper as jwhisper
from repro.serve import decode as jdecode
from repro.serve.batching import Batcher as JBatcher


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tcfgs, tlm, tlayers, twhisper, tsteps, tshard, tdecode, \
        TBatcher, TModelConfig, tree_leaves, tree_map, TorchDispatchMode, \
        aops
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch import configs as tcfgs
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import layers as tlayers
    from repro_torch.models import lm as tlm
    from repro_torch.models import whisper as twhisper
    from repro_torch.models.config import ModelConfig as TModelConfig
    from repro_torch.parallel import sharding as tshard
    from repro_torch.serve import decode as tdecode
    from repro_torch.serve.batching import Batcher as TBatcher
    from repro_torch.tree import tree_leaves, tree_map
    torch.set_num_threads(1)


PHI4, QWEN, WHISPER = ("phi4_mini_3_8b", "qwen3_moe_235b_a22b",
                       "whisper_large_v3")
ATOL = 2e-4
B, N_STEPS, T_MAX = 2, 6, 12
TIE_TOL = 1e-6 * 127
SCALE_RTOL = 1e-6
QUANT_REL_LIMIT = 0.05          # tests/test_models.py:234-250
# serve_loop: 3 slots, requests of uneven prompts, 5 new tokens each
PROMPT_LENS, MAX_NEW, SLOTS, SERVE_T_MAX = (4, 6, 3), 5, 2, 16


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's lowest backend
    optimization level."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "dtype"}
    return TModelConfig(**fields, dtype=torch.float32)


def _leaves(caches):
    """(name, numpy array) per cache field, in order."""
    if isinstance(caches, dict):
        return [(f"{k}.{n}", a) for k in sorted(caches)
                for n, a in _leaves([caches[k]])]
    return [(f"{i}.{f}", np.asarray(
        getattr(c, f).numpy() if hasattr(getattr(c, f), "numpy")
        else getattr(c, f))) for i, c in enumerate(caches)
        for f in c._fields]


class _Unrounded:
    """``layers._quantize_kv`` wrapped: each call's value over its scale,
    unrounded, in call order (every decode step writes k then v of each
    attention layer in turn)."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = tlayers._quantize_kv

        def record(x):
            q, scale = orig(x)
            self.calls.append((x.float() / scale[..., None])
                              .reshape(x.shape[0], -1).numpy())
            return q, scale
        monkeypatch.setattr(tlayers, "_quantize_kv", record)

    def cache_values(self, n_layers: int, shape) -> list:
        """[layer][k or v] arrays of ``shape`` [B, T, K·dh] with each
        step's unrounded values at its position (NaN elsewhere)."""
        out = [[np.full(shape, np.nan, np.float32) for _ in range(2)]
               for _ in range(n_layers)]
        per_step = 2 * n_layers
        for i, vals in enumerate(self.calls):
            step, j = divmod(i, per_step)
            out[j // 2][j % 2][:, step] = vals
        return out


def _assert_int8(got, want, unrounded, where):
    """The int8 leaves equal but at rounding ties, which may land one
    step apart."""
    diff = got.astype(np.int32) - want.astype(np.int32)
    off = diff != 0
    if off.any():
        v = np.abs(unrounded[off])
        tie = np.abs(v - np.floor(v) - 0.5)
        assert np.all(np.abs(diff[off]) == 1) and np.all(tie <= TIE_TOL), \
            (where, int(off.sum()), float(tie.max()))


def _assert_scales(got, want, where):
    np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0,
                               err_msg=where)


@pytest.mark.parametrize("arch", [PHI4, QWEN])
def test_int8_decode_from_init_caches_matches_reference(arch, monkeypatch,
                                                        record_property):
    """``N_STEPS`` decode steps from ``init_caches`` (int8 leaves and
    scales zero), each step's new K/V quantized and written in place at
    its position: the logits of every step and every cache leaf after
    the last."""
    jcfg = dataclasses.replace(jget_smoke(arch), kv_cache_quant=True)
    params = np_spec_params(jlm.lm_specs(jcfg), seed=61)
    tokens = np.random.default_rng(62).integers(
        0, jcfg.vocab, (N_STEPS, B, 1)).astype(np.int32)
    caches = jax.tree.map(jnp.asarray, jlm.init_caches(jcfg, B, T_MAX))
    t0 = time.perf_counter()
    step = _compiled(lambda p, c, t, i: jlm.decode_step(p, jcfg, c, t, i),
                     params, caches, tokens[0], np.int32(0))
    want = []
    for i in range(N_STEPS):
        logits, caches = step(params, caches, tokens[i], np.int32(i))
        want.append(np.asarray(logits))
    record_property("reference_jit_compile_s", time.perf_counter() - t0)

    tcfg = _port_cfg(jcfg)
    tparams = tshard.lm_params_from_numpy(params, tcfg, device="cpu")
    tcaches = tlm.init_caches(tcfg, B, T_MAX, device="cpu")
    assert [type(c).__name__ for c in tcaches] \
        == [type(c).__name__ for c in caches]
    rec = _Unrounded(monkeypatch)
    decode = tsteps.make_decode_step(tcfg)
    with torch.no_grad():
        for i in range(N_STEPS):
            logits, same = decode(tparams, tcaches,
                                  torch.from_numpy(tokens[i]), i)
            assert same is tcaches                  # updated in place
            np.testing.assert_allclose(logits.numpy(), want[i], atol=ATOL,
                                       err_msg=f"step {i}")
    attn = [i for i, (m, _) in enumerate(tcfg.pattern) if m == "attn"]
    n_layers = len(attn) * tcfg.n_periods
    kd = tcfg.n_kv_heads * tcfg.head_dim
    unrounded = rec.cache_values(n_layers, (B, T_MAX, kd))
    for (name, g), (_, w) in zip(_leaves(tcaches), _leaves(caches)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        pos, field = name.split(".")
        if field in ("k", "v"):
            for period in range(tcfg.n_periods):
                layer = period * len(attn) + attn.index(int(pos))
                _assert_int8(g[period], w[period],
                             unrounded[layer][field == "v"],
                             f"{name} period {period}")
        else:
            _assert_scales(g, w, name)


def test_int8_decode_close_to_bf16():
    """``tests/test_models.py::test_quantized_kv_decode_close_to_bf16`` on
    the port: the 32 tokens fed one by one into an int8 ``init_caches``
    cache against a prefill of the first 31 and one decode step of the
    last (the model-dtype ``KVCache``), within 5%."""
    cfg = tcfgs.get_smoke_config(PHI4)
    cfg_q = dataclasses.replace(cfg, kv_cache_quant=True)
    jcfg = jget_smoke(PHI4)
    params = tshard.lm_params_from_numpy(
        np_spec_params(jlm.lm_specs(jcfg), seed=63), cfg, device="cpu")
    S = 32
    tokens = torch.from_numpy(np.random.default_rng(64).integers(
        0, cfg.vocab, (2, S)))
    with torch.no_grad():
        _, caches, pos = tlm.prefill(params, cfg, tokens[:, :-1],
                                     t_max=S + 4)
        assert all(type(c).__name__ == "KVCache" for c in caches)
        ref, _ = tlm.decode_step(params, cfg, caches, tokens[:, -1:], pos)
        caches_q = tlm.init_caches(cfg_q, 2, S + 4, device="cpu")
        for t in range(S):
            logits, caches_q = tlm.decode_step(params, cfg_q, caches_q,
                                               tokens[:, t:t + 1], t)
    assert caches_q[0].k.dtype == torch.int8
    rel = float((ref - logits).abs().max()) / float(ref.abs().max())
    assert rel < QUANT_REL_LIMIT, rel


def test_whisper_int8_decoder_caches_match_reference(monkeypatch,
                                                     record_property):
    """Whisper's decoder from ``init_decoder_caches`` with int8 self and
    cross caches: ``N_STEPS`` steps through ``make_decode_step``, the
    logits of each, the self cache written in place (int8 and scales as
    above), the cross cache read and never written."""
    jcfg = dataclasses.replace(jget_smoke(WHISPER), kv_cache_quant=True)
    params = np_spec_params(jwhisper.whisper_specs(jcfg), seed=65)
    tokens = np.random.default_rng(66).integers(
        0, jcfg.vocab, (N_STEPS, B, 1)).astype(np.int32)
    caches = jax.tree.map(jnp.asarray,
                          jwhisper.init_decoder_caches(jcfg, B, T_MAX))
    t0 = time.perf_counter()
    step = _compiled(lambda p, c, t, i: jwhisper.whisper_decode_step(
        p, jcfg, c, t, i), params, caches, tokens[0], np.int32(0))
    want = []
    for i in range(N_STEPS):
        logits, caches = step(params, caches, tokens[i], np.int32(i))
        want.append(np.asarray(logits))
    record_property("reference_jit_compile_s", time.perf_counter() - t0)

    tcfg = _port_cfg(jcfg)
    tparams = tshard.lm_params_from_numpy(params, tcfg, device="cpu")
    tcaches = twhisper.init_decoder_caches(tcfg, B, T_MAX, device="cpu")
    versions = [t._version for t in tcaches["cross"]]
    rec = _Unrounded(monkeypatch)
    decode = tsteps.make_decode_step(tcfg)
    with torch.no_grad():
        for i in range(N_STEPS):
            logits, _ = decode(tparams, tcaches,
                               torch.from_numpy(tokens[i]), i)
            np.testing.assert_allclose(logits.numpy(), want[i], atol=ATOL,
                                       err_msg=f"step {i}")
    assert [t._version for t in tcaches["cross"]] == versions
    kd = tcfg.n_kv_heads * tcfg.head_dim
    unrounded = rec.cache_values(tcfg.n_layers, (B, T_MAX, kd))
    for (name, g), (_, w) in zip(_leaves(tcaches), _leaves(caches)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        which, field = name.split(".")[0], name.split(".")[-1]
        if field.endswith("_scale"):
            _assert_scales(g, w, name)
        elif which == "cross":
            assert not g.any() and not w.any(), name
        else:
            for layer in range(tcfg.n_layers):
                _assert_int8(g[layer], w[layer],
                             unrounded[layer][field == "v"],
                             f"{name} layer {layer}")


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


class _HandingBatcher(JBatcher):
    """The reference's batcher, noting for each token it hands out the
    top-2 margin of the logits row it came from (a slot still feeding
    its prompt is handed a 0, which no near-tie can change)."""

    def __init__(self, rec, **kw):
        super().__init__(**kw)
        self.rec, self.margin = rec, {}

    def record_tokens(self, token_per_slot):
        logits = self.rec.seen[-1]
        for i, req in enumerate(self.slots):
            if req is not None and not req.done:
                tok = int(token_per_slot[i])
                top2 = np.sort(logits[i])[-2:]
                self.margin[req.rid, len(req.tokens)] = (
                    float(top2[1] - top2[0])
                    if tok == int(np.argmax(logits[i])) else np.inf)
        super().record_tokens(token_per_slot)


def _submit(batcher, vocab):
    rng = np.random.default_rng(67)
    for n in PROMPT_LENS:
        batcher.submit([int(t) for t in rng.integers(0, vocab, n)],
                       max_new_tokens=MAX_NEW)
    return batcher


def test_serve_loop_on_an_int8_config_matches_reference(monkeypatch):
    """``serve_loop`` with ``kv_cache_quant``: its caches from
    ``init_caches`` are int8, and it completes the reference's requests
    in the reference's steps with the same tokens."""
    jcfg = dataclasses.replace(jget_smoke(PHI4), kv_cache_quant=True)
    tcfg = _port_cfg(jcfg)
    params = np_spec_params(jlm.lm_specs(jcfg), seed=68)
    rec = _RecordingJnp()
    monkeypatch.setattr(jdecode, "jnp", rec)
    jb = _submit(_HandingBatcher(rec, max_batch=SLOTS), jcfg.vocab)
    jdone, jsteps, _ = jdecode.serve_loop(params, jcfg, jb,
                                          t_max=SERVE_T_MAX)
    made = []
    orig = tlm.init_caches
    monkeypatch.setattr(tlm, "init_caches", lambda *a, **k: made.append(
        orig(*a, **k)) or made[-1])
    tb = _submit(TBatcher(max_batch=SLOTS), jcfg.vocab)
    tdone, tsteps_, tps = tdecode.serve_loop(
        tshard.lm_params_from_numpy(params, tcfg, device="cpu"), tcfg, tb,
        t_max=SERVE_T_MAX)
    assert made and made[0][0].k.dtype == torch.int8
    assert tsteps_ == jsteps and tps > 0
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert len(tdone) == len(PROMPT_LENS)
    want = {r.rid: r.tokens for r in jdone}
    compared = 0
    for r in tdone:
        assert len(r.tokens) == len(want[r.rid]) == MAX_NEW
        ok = next((i for i in range(MAX_NEW)
                   if jb.margin[r.rid, i] <= ATOL), MAX_NEW)
        assert r.tokens[:ok] == want[r.rid][:ok], r.rid
        compared += ok
    assert compared >= len(PROMPT_LENS) * MAX_NEW - 2, jb.margin


class _MMCount:
    """A dispatch mode counting ``aten.mm`` calls (the flash Function's
    forward runs counted apart)."""

    def __init__(self):
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten.mm.default:
                    outer.mm += 1
                return func(*args, **(kwargs or {}))
        self.mm, self.mode = 0, Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


DOTS_CASES = [(PHI4, "xla"), (PHI4, "flash_interpret"), (QWEN, "xla")]


@pytest.mark.parametrize("arch,impl", DOTS_CASES,
                         ids=[f"{a}-{i}" for a, i in DOTS_CASES])
def test_dots_remat_keeps_the_products(arch, impl, monkeypatch):
    """``remat_policy="dots"``: the gradients ``torch.equal`` to
    ``"full"``'s and to no remat's; its backward recomputes no
    ``aten.mm`` (it launches the no-remat backward's count), while
    ``"full"``'s recomputes the periods' products (all but each period's
    last MLP product, whose output no backward reads: the checkpoint stops
    its rerun there); the flash Function's forward reruns under both."""
    base = dataclasses.replace(tcfgs.get_smoke_config(arch), attn_impl=impl)
    params = tshard.init_params(tsteps.model_specs(base),
                                torch.Generator().manual_seed(5),
                                base.dtype, device="cpu")
    S = 128 if impl != "xla" else 32
    tokens = torch.randint(0, base.vocab, (1, S),
                           generator=torch.Generator().manual_seed(6))
    batch = {"tokens": tokens, "labels": tokens}
    runs = []
    orig = aops._FlashMHA.forward

    def counted(ctx, *a):
        runs[-1]["flash_fwd"] += 1
        return orig(ctx, *a)
    monkeypatch.setattr(aops._FlashMHA, "forward", staticmethod(counted))
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        runs.append({"flash_fwd": 0})
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        it = iter(leaves)
        tracked = tree_map(lambda _: next(it), params)
        with _MMCount() as fwd:
            loss, _ = tsteps._loss_fn(cfg)(tracked, batch)
        with _MMCount() as bwd:
            grads = torch.autograd.grad(loss, leaves)
        runs[-1].update(grads=grads, fwd_mm=fwd.mm, bwd_mm=bwd.mm)
    none, full, dots = runs
    for run in (full, dots):
        assert all(torch.equal(a, b)
                   for a, b in zip(run["grads"], none["grads"]))
    assert full["fwd_mm"] == dots["fwd_mm"] == none["fwd_mm"]
    assert dots["bwd_mm"] == none["bwd_mm"]
    period_mm = none["fwd_mm"] - 1          # less the CE's product
    dense = any(f == "mlp" for _, f in base.pattern)
    assert full["bwd_mm"] - none["bwd_mm"] == period_mm - (
        base.n_periods if dense else 0) > 0
    n_attn = base.n_periods * sum(m == "attn" for m, _ in base.pattern)
    want = (0, 0, 0) if impl == "xla" else (n_attn, 2 * n_attn, 2 * n_attn)
    assert tuple(r["flash_fwd"] for r in runs) == want
