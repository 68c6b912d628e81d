"""Port parity: the QuadConv contraction, one QuadConv layer and the
autoencoder (``repro_torch``) against the JAX reference, in fp32.

Tolerances (fp32, sums taken in other orders by the two frameworks):
1e-5 for the contraction and one layer, 1e-4 for the encoder and decoder,
whose LayerNorms and heads compound the rounding.  Weights are the
made with numpy from a seed in the reference's layout and carried across
with ``params_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (np_autoencoder_params, np_quadconv_params,
                           torch_ae_config)
from repro.configs.quadconv_ae import smoke_config
from repro.kernels.quadconv import quadconv_contract as jcontract
from repro.ml import autoencoder as jae
from repro.ml.quadconv import QuadConv as JQuadConv


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tcontract, tae, TQuadConv
    import torch
    from repro_torch.kernels.quadconv import quadconv_contract as tcontract
    from repro_torch.ml import autoencoder as tae
    from repro_torch.ml.quadconv import QuadConv as TQuadConv
    # tiny shapes: one core, leaving the rest to the other test workers
    torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("B,I,C,J,O", [(3, 16, 4, 8, 4), (2, 24, 16, 8, 16)])
def test_contract_matches_reference(B, I, C, J, O, mode):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((B, I, C)).astype(np.float32)
    w = rng.random(I).astype(np.float32)
    g = rng.standard_normal((J, I, O, C)).astype(np.float32)
    want = jcontract(jnp.asarray(f), jnp.asarray(w), jnp.asarray(g), mode,
                     8, 128, 128)
    got = tcontract(torch.as_tensor(f), torch.as_tensor(w),
                    torch.as_tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_quadconv_layer_matches_reference():
    rng = np.random.default_rng(1)
    n_in, n_out = 32, 8
    jconv = JQuadConv(c_in=4, c_out=8, mlp_width=16, mlp_depth=3,
                      mode="ref")
    tconv = TQuadConv(c_in=4, c_out=8, mlp_width=16, mlp_depth=3)
    params = np_quadconv_params(rng, 4, 8, 16, 3, n_in)
    f = rng.standard_normal((2, n_in, 4)).astype(np.float32)
    cin = rng.random((n_in, 3)).astype(np.float32)
    cout = rng.random((n_out, 3)).astype(np.float32)
    want = jax.jit(jconv.apply)(params, jnp.asarray(f), jnp.asarray(cin),
                                jnp.asarray(cout))
    got = tconv.apply(tae.params_from_numpy(params, "cpu"),
                      torch.as_tensor(f), torch.as_tensor(cin),
                      torch.as_tensor(cout))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_autoencoder_matches_reference():
    """``encode`` at the smoke config, and ``decode`` of its latent."""
    jcfg = smoke_config()
    tcfg = torch_ae_config(jcfg)
    rng = np.random.default_rng(2)
    coords = rng.random((jcfg.n_points, 3)).astype(np.float32)
    f = rng.standard_normal((2, jcfg.n_points, jcfg.channels)) \
        .astype(np.float32)
    jparams = np_autoencoder_params(jcfg, seed=3)
    tparams = tae.params_from_numpy(jparams, "cpu")
    jlevels = jae.coords_pyramid(jcfg, jnp.asarray(coords))
    tlevels = tae.coords_pyramid(tcfg, torch.as_tensor(coords))
    z_j = jax.jit(lambda p, x: jae.encode(p, jcfg, jlevels, x))(
        jparams, jnp.asarray(f))
    z_t = tae.encode(tparams, tcfg, tlevels, torch.as_tensor(f))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-4,
                               atol=1e-4)
    rec_j = jax.jit(lambda p, z: jae.decode(p, jcfg, jlevels, z))(
        jparams, z_j)
    rec_t = tae.decode(tparams, tcfg, tlevels, torch.as_tensor(
        np.array(z_j)))
    np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j), rtol=1e-4,
                               atol=1e-4)
