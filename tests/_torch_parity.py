"""Shared inputs for the ``repro_torch`` parity tests: configs mirrored
across the two packages, and autoencoder and LM weights made with numpy
from a seed, in the reference's params layout (so both packages get the same
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


def np_lm_params(jcfg, seed: int) -> dict:
    """LM params in the reference's ``lm.lm_specs`` layout (leaves stacked
    ``[n_periods, ...]``), drawn with numpy from ``seed``
    (``np_spec_params``)."""
    from repro.models import lm
    return np_spec_params(lm.lm_specs(jcfg), seed)


def np_spec_params(specs, seed: int) -> dict:
    """A reference specs tree's params drawn with numpy from ``seed``:
    each spec's own initializer (fan-in normal over ``shape[-2]``, embed
    std 0.02, its ``scale``), except that ``ones`` / ``zeros`` leaves
    (norm scales, ``a_log``, ``d``, ``dt_bias``) get a small random offset
    so the parity tests exercise them."""
    from repro.parallel.sharding import ParamSpec
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("normal", "embed"):
            if spec.scale is not None:
                std = spec.scale
            elif spec.init == "embed":
                std = 0.02
            else:
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                    else spec.shape[-1]
                std = np.sqrt(1.0 / max(1, fan_in))
            return (rng.standard_normal(spec.shape) * std).astype(np.float32)
        base = 1.0 if spec.init == "ones" else 0.0
        return (base + 0.1 * rng.standard_normal(spec.shape)) \
            .astype(np.float32)

    def walk(tree):
        if isinstance(tree, ParamSpec):
            return draw(tree)
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return [walk(t) for t in tree]

    return walk(specs)


def np_resnet50_params(seed: int, num_classes: int = 1000) -> dict:
    """ResNet-50 params in the ``ml.resnet.init_resnet50`` layout (HWIO
    conv weights, folded-BN ``scale``/``bias``, ``fc`` ``w [2048,
    classes]``), drawn with numpy from ``seed``: the reference's fan-in
    normal weights, and BN scales and biases and the fc bias offset from
    its ones and zeros by 0.1·N(0, 1) so the parity tests exercise them."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, cin, cout):
        return (rng.standard_normal((kh, kw, cin, cout))
                * np.sqrt(2.0 / (kh * kw * cin))).astype(np.float32)

    def bn(c):
        return {"scale": (1 + 0.1 * rng.standard_normal(c))
                .astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}

    params = {"stem": conv(7, 7, 3, 64), "bn_stem": bn(64), "stages": []}
    cin = 64
    for s, blocks in enumerate((3, 4, 6, 3)):
        cmid = 64 * 2 ** s
        stage = []
        for b in range(blocks):
            cout = cmid * 4
            p = {"conv1": conv(1, 1, cin, cmid), "bn1": bn(cmid),
                 "conv2": conv(3, 3, cmid, cmid), "bn2": bn(cmid),
                 "conv3": conv(1, 1, cmid, cout), "bn3": bn(cout)}
            if (b == 0 and s > 0) or cin != cout:
                p["proj"] = conv(1, 1, cin, cout)
                p["bn_proj"] = bn(cout)
            stage.append(p)
            cin = cout
        params["stages"].append(stage)
    params["fc"] = {"w": (rng.standard_normal((cin, num_classes))
                          * np.sqrt(1.0 / cin)).astype(np.float32),
                    "b": (0.1 * rng.standard_normal(num_classes))
                    .astype(np.float32)}
    return params
