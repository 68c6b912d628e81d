"""Port parity: the training path's pieces (``repro_torch``) against the
JAX reference, in fp32 on the CPU.

* the QuadConv contraction's gradients (the autograd Function's einsum
  backward) against ``jax.vjp`` of the reference with ``mode="ref"``:
  rtol 1e-5, atol 1e-6 (fp32 sums in other orders);
* one Adam update from a mid-training state against ``optimizer.adam``:
  1e-6 (the same elementwise arithmetic; only ``pow`` may differ by an
  ulp);
* one microstep of the smoke autoencoder — the loss and every parameter
  gradient against ``jax.value_and_grad``: 1e-4 of each leaf's largest
  gradient (fp32 through two QuadConv blocks each way and the heads).
  The gradient reaches the filter MLPs through ``kernel_tensor``'s
  in-place window multiply, which this covers;
* the port's fused and per-verb trainer tiers give a bit-identical
  ``TrainState`` from the same table, weights and draws, as the
  reference asserts for its own tiers.

The fused epochs against the reference's, with the reference's draws, are
in ``tests/test_torch_insitu.py`` (one reference session serves both).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (np_autoencoder_params, torch_ae_config,
                           uniforms_for_ranks)
from repro.configs.quadconv_ae import smoke_config, smoke_grid_config
from repro.kernels.quadconv import quadconv_contract as jcontract
from repro.ml import autoencoder as jae
from repro.sim import flatplate as jfp
from repro.train import optimizer as jopt


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TClient, TServer, TTableSpec, tcontract, tae, ttr, tfp, topt
    global tree_map
    import torch
    from repro_torch.core import Client as TClient
    from repro_torch.core import StoreServer as TServer
    from repro_torch.core import TableSpec as TTableSpec
    from repro_torch.kernels.quadconv import quadconv_contract as tcontract
    from repro_torch.ml import autoencoder as tae
    from repro_torch.ml import trainer as ttr
    from repro_torch.sim import flatplate as tfp
    from repro_torch.train import optimizer as topt
    from repro_torch.tree import tree_map
    # tiny shapes: one core, leaving the rest to the other test workers
    torch.set_num_threads(1)


def _leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("B,I,C,J,O", [(3, 16, 4, 8, 4), (2, 12, 16, 6, 16)])
def test_contract_grads_match_reference_vjp(B, I, C, J, O):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((B, I, C)).astype(np.float32)
    w = rng.random(I).astype(np.float32)
    g = rng.standard_normal((J, I, O, C)).astype(np.float32)
    ct = rng.standard_normal((B, J, O)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jcontract(a, b, c, "ref"),
                     jnp.asarray(f), jnp.asarray(w), jnp.asarray(g))
    want = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in (f, w, g)]
    tcontract(*ts).backward(torch.as_tensor(ct))
    for name, t, ref in zip(("df", "dw", "dG"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_adam_update_matches_reference():
    """One update from step 4 with non-zero moments."""
    rng = np.random.default_rng(1)
    shapes = {"w": (5, 3), "b": (3,)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    mu = {k: 0.1 * rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: 0.01 * rng.random(s).astype(np.float32)
          for k, s in shapes.items()}
    jtx = jopt.adam(1e-3)
    jstate = jopt.AdamState(step=jnp.int32(4), mu=jax.tree.map(jnp.asarray,
                                                               mu),
                            nu=jax.tree.map(jnp.asarray, nu))
    jp = jax.tree.map(jnp.asarray, p)
    jup, jst = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
    jnew = jopt.apply_updates(jp, jup)
    tstate = ttr.train_state_from_numpy(p, mu, nu, step=4, device="cpu")
    tup, tst = topt.adam(1e-3).update(tree_map(torch.as_tensor, g),
                                      tstate.opt_state, tstate.params)
    tnew = topt.apply_updates(tstate.params, tup)
    assert int(tst.step) == int(jst.step) == 5
    for k in shapes:
        for got, want in ((tnew[k], jnew[k]), (tst.mu[k], jst.mu[k]),
                          (tst.nu[k], jst.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    # the input state is left as it was (the update is functional)
    np.testing.assert_array_equal(tstate.params["w"].numpy(), p["w"])


def test_microstep_loss_and_grads_match_reference(record_property):
    """Also records the reference's compile-and-run time of the jitted
    ``value_and_grad`` (junit property ``reference_value_and_grad_s``),
    the bulk of this test's cost."""
    jcfg = smoke_config()
    tcfg = torch_ae_config(jcfg)
    fcfg = smoke_grid_config()
    params = np_autoencoder_params(jcfg, seed=5)
    rng = np.random.default_rng(6)
    batch = rng.standard_normal((4, jcfg.n_points, jcfg.channels)) \
        .astype(np.float32)
    jlevels = jae.coords_pyramid(jcfg, jfp.grid_coords(fcfg))
    tlevels = tae.coords_pyramid(tcfg, tfp.grid_coords(fcfg, "cpu"))
    t0 = time.perf_counter()
    jloss, jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(
        lambda p, x: jae.loss_fn(p, jcfg, jlevels, x)))(
            params, jnp.asarray(batch)))
    record_property("reference_value_and_grad_s", time.perf_counter() - t0)
    tparams = tae.params_from_numpy(params, "cpu")
    tloss, tgrads = ttr.value_and_grad(
        lambda p: tae.loss_fn(p, tcfg, tlevels, torch.as_tensor(batch)),
        tparams)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    jl, tl = jax.tree.leaves(jgrads), _leaves(tgrads)
    assert len(jl) == len(tl) == 46
    for got, want in zip(tl, jl):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale
    # the gradient reached the filter MLPs (through kernel_tensor's mul_)
    assert float(tgrads["enc"][0]["mlp"][0]["w"].abs().max()) > 0


def test_fused_and_per_verb_tiers_are_bit_identical():
    """Both port tiers, from the same table, weights and draws (fixed
    ranks and generator draws), leave the same bits in every TrainState
    leaf."""
    jcfg = smoke_config()
    fcfg = smoke_grid_config()
    n = fcfg.n_points
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((8, 4, n)).astype(np.float32)
    params = np_autoencoder_params(jcfg, seed=8)
    coords = tfp.grid_coords(fcfg, "cpu")
    gen = torch.Generator().manual_seed(9)
    cfgs = {fused: ttr.TrainerConfig(torch_ae_config(jcfg), epochs=2,
                                     gather=3, batch_size=2, lr=1e-3,
                                     fused=fused) for fused in (True, False)}
    epochs = [ttr.EpochDraws(torch.as_tensor(uniforms_for_ranks([7, 3, 3],
                                                                len(rows))),
                             torch.tensor(2), torch.tensor([1, 0])),
              ttr.draw_epoch(cfgs[True], gen, "cpu")]
    draws = ttr.TrainDraws(
        torch.as_tensor(uniforms_for_ranks([1, 2, 5], len(rows))), epochs)
    states = {}
    for fused, cfg in cfgs.items():
        srv = TServer(device="cpu")
        srv.create_table(TTableSpec("field", shape=(4, n), capacity=12))
        for i, row in enumerate(rows):
            srv.put("field", i + 1, torch.as_tensor(row))
        state, hist, _, _ = ttr.insitu_train(
            TClient(srv), coords, cfg,
            state=ttr.train_state_from_numpy(params, device="cpu"),
            draws=draws)
        assert len(hist) == 2 and srv.stats()["op_count"] == 8 + 1 + 2
        states[fused] = state
    a, b = _leaves(states[True]), _leaves(states[False])
    assert len(a) == len(b) > 3 * 46
    for x, y in zip(a, b):
        assert torch.equal(x, y)
