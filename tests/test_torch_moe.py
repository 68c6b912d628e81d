"""Port parity for the MoE FFN: ``repro_torch.models.moe`` against
``repro.models.moe`` on the same numpy weights and inputs, in fp32.

Cases: the Qwen3-MoE smoke layer (8 experts, top-2), the Llama-4 Scout
smoke layer (4 experts, top-1, the shared expert), ``tests/test_models.py``'s
capacity case (16 identical tokens, 2 experts, ``capacity_factor`` 1.0)
and the Qwen3-MoE layer at ``capacity_factor`` 1.0 on random tokens,
where some but not all (token, choice) pairs drop.  The reference runs
once per case under ``jax.jit``.  Outputs must agree within 1e-5 of
max|y| and the aux term within 1e-6 relative; the dropped set must be
the reference's exactly, and equal to an independent count (the pairs
walked token-major, k inner, each expert's pairs beyond its capacity
dropped).  So that both packages decide the routing the same way, the
reference's smallest gap between the k-th and (k+1)-th router
probability must exceed 1e-4.  Then ``tests/test_models.py``'s
dense-routing loop, run on the port.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_spec_params
from repro.configs import get_smoke_config as jget_smoke
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file."""
    global torch, tmoe, TModelConfig, tree_map
    import torch
    from repro_torch.models import moe as tmoe
    from repro_torch.models.config import ModelConfig as TModelConfig
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)


Y_RTOL = 1e-5        # of max|y|
AUX_RTOL = 1e-6
MIN_GAP = 1e-4

# tests/test_models.py's capacity case: every token routes identically
_CAPACITY_CFG = dict(name="m", n_layers=2, d_model=8, n_heads=2,
                     n_kv_heads=2, d_ff=16, vocab=64,
                     pattern=(("attn", "moe"),), n_experts=2, top_k=1,
                     d_ff_moe=16, capacity_factor=1.0)


def _case(name: str):
    """(reference config, x [B, S, D]) of one case."""
    rng = np.random.default_rng(11)
    if name == "identical_cf1":
        return JModelConfig(**_CAPACITY_CFG), np.full((1, 16, 8), 0.3,
                                                      np.float32)
    arch = {"qwen3": "qwen3_moe_235b_a22b", "llama4": "llama4_scout_17b_a16e",
            "random_cf1": "qwen3_moe_235b_a22b"}[name]
    jcfg = jget_smoke(arch)
    S = 16
    if name == "random_cf1":
        jcfg, S = dataclasses.replace(jcfg, capacity_factor=1.0), 64
    return jcfg, rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "dtype"}
    return TModelConfig(**fields, dtype=torch.float32)


def _reference_routing(params, cfg, x):
    """The reference's routing (``repro/models/moe.py:63-74``, the same
    ops): sorted router probabilities and the kept (token, choice)
    pairs."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("bsd,de->bse", x, params["router"],
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    flat_e = expert_idx.reshape(B, S * k)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.einsum("bte,bte->bt", jnp.cumsum(onehot, axis=1), onehot) - 1
    return (jnp.sort(probs, axis=-1)[..., ::-1], expert_idx,
            pos < jmoe.capacity(cfg, S))


_REFERENCE: dict = {}


def _reference(name: str) -> dict:
    if name in _REFERENCE:
        return _REFERENCE[name]
    t0 = time.perf_counter()
    jcfg, x = _case(name)
    params = np_spec_params(jmoe.moe_specs(jcfg), seed=3)

    def run(p, x):
        return (*jmoe.moe_apply(p, jcfg, x), *_reference_routing(p, jcfg, x))

    y, aux, probs, idx, keep = jax.jit(run)(params, x)
    out = {"cfg": jcfg, "x": x, "params": params, "y": np.asarray(y),
           "aux": float(aux), "probs": np.asarray(probs),
           "idx": np.asarray(idx), "keep": np.asarray(keep),
           "reference_s": time.perf_counter() - t0}
    _REFERENCE[name] = out
    return out


def priority_keep(expert_idx: np.ndarray, E: int, C: int) -> np.ndarray:
    """The kept (token, choice) pairs by an independent count: in each
    batch row, walk the pairs token-major with the k choices inner, and
    keep a pair while its expert has had fewer than C pairs before it."""
    B = expert_idx.shape[0]
    flat = expert_idx.reshape(B, -1)
    keep = np.zeros(flat.shape, bool)
    for b in range(B):
        seen = np.zeros(E, int)
        for t, e in enumerate(flat[b]):
            keep[b, t] = seen[e] < C
            seen[e] += 1
    return keep


def _to_torch(params):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), params)


@pytest.mark.parametrize("name", ["qwen3", "llama4", "identical_cf1",
                                  "random_cf1"])
def test_moe_apply_matches_reference(name, record_property):
    ref = _reference(name)
    record_property("reference_jit_compile_s", ref["reference_s"])
    jcfg, cfg = ref["cfg"], _port_cfg(ref["cfg"])
    k, E = cfg.top_k, cfg.n_experts
    gap = ref["probs"][..., k - 1] - ref["probs"][..., k]
    assert float(gap.min()) > MIN_GAP, float(gap.min())
    params = _to_torch(ref["params"])
    x = torch.from_numpy(ref["x"])
    routing = tmoe.route(params, cfg, x)
    y, aux = tmoe.moe_apply(params, cfg, x, routing)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_array_equal(routing.expert_idx.numpy(), ref["idx"])
    keep = routing.keep.numpy()
    np.testing.assert_array_equal(keep, ref["keep"])
    C = tmoe.capacity(cfg, x.shape[1])
    assert C == jmoe.capacity(jcfg, x.shape[1])
    np.testing.assert_array_equal(keep, priority_keep(ref["idx"], E, C))
    if name.endswith("cf1"):
        assert 0 < int((~keep).sum()) < keep.size, int((~keep).sum())
    else:
        assert keep.all()
    tol = Y_RTOL * float(np.abs(ref["y"]).max())
    np.testing.assert_allclose(y.numpy(), ref["y"], rtol=0, atol=tol)
    assert abs(float(aux) - ref["aux"]) <= AUX_RTOL * abs(ref["aux"])
    if name == "identical_cf1":
        # over-capacity tokens get zero expert output
        norms = np.linalg.norm(y[0].numpy(), axis=-1)
        assert (norms < 1e-6).sum() == 16 - C


def test_moe_matches_dense_routing():
    """``tests/test_models.py::TestMoE::test_matches_dense_routing`` on the
    port: with room for every pair (``capacity_factor`` 8), y is each
    token's top-2 experts' swiglu MLPs weighted by the renormalized gates,
    computed token by token in float64."""
    jcfg = JModelConfig(name="m", n_layers=2, d_model=16, n_heads=2,
                        n_kv_heads=2, d_ff=32, vocab=64,
                        pattern=(("attn", "moe"),), n_experts=4, top_k=2,
                        d_ff_moe=32, capacity_factor=8.0)
    cfg = _port_cfg(jcfg)
    mp = np_spec_params(jmoe.moe_specs(jcfg), seed=4)
    xm = (np.random.default_rng(5).standard_normal((2, 8, 16)) * 0.5) \
        .astype(np.float32)
    y, aux = tmoe.moe_apply(_to_torch(mp), cfg, torch.from_numpy(xm))
    w = {k: v.astype(np.float64) for k, v in mp.items()}
    logits = xm.astype(np.float64) @ w["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    gi = np.argsort(-probs, axis=-1, kind="stable")[..., :2]
    gv = np.take_along_axis(probs, gi, -1)
    g = gv / gv.sum(-1, keepdims=True)
    ref = np.zeros(xm.shape)
    for b_ in range(2):
        for s_ in range(8):
            for j in range(2):
                e = int(gi[b_, s_, j])
                t = xm[b_, s_].astype(np.float64)
                h = t @ w["w_up"][e]
                gt = t @ w["w_gate"][e]
                o = (gt / (1 + np.exp(-gt)) * h) @ w["w_down"][e]
                ref[b_, s_] += g[b_, s_, j] * o
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=Y_RTOL * float(np.abs(ref).max()))
    assert float(aux) > 0


def test_moe_gelu_and_squared_relu_match_reference():
    """The two other activations' expert branches (the smoke configs are
    all swiglu), at the Qwen3-MoE smoke widths."""
    rng = np.random.default_rng(6)
    for act in ("gelu", "squared_relu"):
        jcfg = dataclasses.replace(jget_smoke("qwen3_moe_235b_a22b"),
                                   mlp_act=act)
        params = np_spec_params(jmoe.moe_specs(jcfg), seed=9)
        assert "w_gate" not in params
        x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
        y, aux = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x))(params, x)
        ty, taux = tmoe.moe_apply(_to_torch(params), _port_cfg(jcfg),
                                  torch.from_numpy(x))
        np.testing.assert_allclose(
            ty.numpy(), np.asarray(y), rtol=0,
            atol=Y_RTOL * float(np.abs(np.asarray(y)).max()), err_msg=act)
        assert abs(float(taux) - float(aux)) <= AUX_RTOL * abs(float(aux))


def test_top_k_ties_take_the_lower_expert_first():
    """Equal router probabilities (a zero router: all equal) route to the
    lowest expert indices, in order, as ``jax.lax.top_k`` does."""
    jcfg = jget_smoke("qwen3_moe_235b_a22b")
    cfg = _port_cfg(jcfg)
    params = _to_torch(np_spec_params(jmoe.moe_specs(jcfg), seed=1))
    params["router"].zero_()
    x = torch.randn((1, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    r = tmoe.route(params, cfg, x)
    assert r.expert_idx.tolist() == [[[0, 1]] * 8]
    _, want = jax.lax.top_k(jnp.full((8, cfg.n_experts), 0.125), 2)
    assert np.asarray(want).tolist() == r.expert_idx[0].tolist()


def test_router_sums_bf16_values_in_fp32():
    """On bf16 inputs the router's product is the reference's fp32 sum of
    the bf16 values (``preferred_element_type=float32``), not a bf16
    product cast afterwards, which would round the logits to 8 bits: the
    gates agree within 1e-5 relative and the experts exactly."""
    jcfg = jget_smoke("qwen3_moe_235b_a22b")
    cfg = dataclasses.replace(_port_cfg(jcfg), dtype=torch.bfloat16)
    params = np_spec_params(jmoe.moe_specs(jcfg), seed=2)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    xb, rb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(params["router"],
                                                       jnp.bfloat16)
    logits = jnp.einsum("bsd,de->bse", xb, rb,
                        preferred_element_type=jnp.float32)
    gv, gi = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)
    gates = np.asarray(gv / gv.sum(-1, keepdims=True))
    tparams = {"router": torch.from_numpy(np.asarray(
        rb.astype(jnp.float32))).to(torch.bfloat16)}
    r = tmoe.route(tparams, cfg, torch.from_numpy(np.asarray(
        xb.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(gi))
    np.testing.assert_allclose(r.gates.numpy(), gates, rtol=1e-5, atol=0)
