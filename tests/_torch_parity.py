"""Shared inputs for the ``repro_torch`` parity tests: configs mirrored
across the two packages and autoencoder weights made with numpy from a
seed, in the reference's params layout (so both packages get the same
numbers without paying for the reference's ``jax.random`` init)."""

from __future__ import annotations

import numpy as np


def torch_ae_config(jcfg):
    """The port's ``AEConfig`` with the reference config's widths."""
    from repro_torch.ml import autoencoder as tae
    return tae.AEConfig(n_points=jcfg.n_points, channels=jcfg.channels,
                        internal=jcfg.internal, latent=jcfg.latent,
                        blocks=jcfg.blocks, pool=jcfg.pool,
                        mlp_width=jcfg.mlp_width, mlp_depth=jcfg.mlp_depth,
                        support=jcfg.support)


def uniforms_for_ranks(ranks, nvalid: int) -> np.ndarray:
    """Uniform draws that ``store.sample`` turns back into exactly
    ``ranks`` over ``nvalid`` live elements: the middle of each rank's
    interval, ``(r + 0.5) / max(nvalid, 1)``, in float32."""
    top = max(int(nvalid), 1)
    return ((np.asarray(ranks, np.float64) + 0.5) / top).astype(np.float32)


def np_quadconv_params(rng, c_in, c_out, width, depth, n_in) -> dict:
    """One QuadConv layer's params (``ml.quadconv.QuadConv.init`` layout):
    ``quad_w [n_in]``, ``mlp [{w [din, dout], b [dout]}]``, ``bias``."""
    sizes = (3,) + (width,) * (depth - 1) + (c_out * c_in,)
    mlp = [{"w": (rng.standard_normal((din, dout)) * np.sqrt(2.0 / din))
                 .astype(np.float32),
            "b": (0.1 * rng.standard_normal(dout)).astype(np.float32)}
           for din, dout in zip(sizes[:-1], sizes[1:])]
    return {"quad_w": (rng.random(n_in) / n_in).astype(np.float32),
            "mlp": mlp,
            "bias": (0.1 * rng.standard_normal(c_out)).astype(np.float32)}


def _linear(rng, din, dout) -> dict:
    return {"w": (rng.standard_normal((din, dout)) / np.sqrt(din))
                 .astype(np.float32),
            "b": (0.1 * rng.standard_normal(dout)).astype(np.float32)}


def np_autoencoder_params(jcfg, seed: int) -> dict:
    """Autoencoder params in the ``ml.autoencoder.init_autoencoder``
    layout, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def block(c_in, n_in):
        p = np_quadconv_params(rng, c_in, jcfg.internal, jcfg.mlp_width,
                               jcfg.mlp_depth, n_in)
        p["ln_scale"] = (1 + 0.1 * rng.standard_normal(jcfg.internal)) \
            .astype(np.float32)
        p["ln_bias"] = (0.1 * rng.standard_normal(jcfg.internal)) \
            .astype(np.float32)
        return p

    enc, c = [], jcfg.channels
    for b in range(jcfg.blocks):
        enc.append(block(c, jcfg.level_points(b)))
        c = jcfg.internal
    dec = [block(jcfg.internal, jcfg.level_points(jcfg.blocks - b - 1))
           for b in range(jcfg.blocks)]
    return {"enc": enc, "dec": dec,
            "enc_head": _linear(rng, jcfg.bottleneck, jcfg.latent),
            "dec_head": _linear(rng, jcfg.latent, jcfg.bottleneck),
            "out_head": _linear(rng, jcfg.internal, jcfg.channels)}
