"""ResNet-50 — the paper's inference benchmark model (§3.2).

Port of ``src/repro/ml/resnet.py``: the bottleneck-v1.5 network
([N, 3, 224, 224] → [N, 1000], stages 3-4-6-3) as init/apply functions
over a params dict with the reference's layout.  Batch norm runs in
inference mode (folded scale and shift); the weights are random from a
seed, since the benchmarks measure transfer and evaluation cost, not
accuracy.

Layout.  ``x`` is NCHW at the public functions, as in the reference, and
every conv weight has the reference's HWIO shape ``[kh, kw, cin, cout]``.
The convolutions run in NCHW on cuDNN (``F.conv2d``), which wants OIHW:
so :func:`init_resnet50` and :func:`resnet50_from_numpy` store each conv
weight as an HWIO *view* of an OIHW-contiguous tensor, and the apply
permutes it back for free — no per-call weight copy, no activation
transposes.  (A plain contiguous HWIO weight works too; cuDNN then copies
it each call.)  NCHW rather than channels-last, because that is the
interface's layout and the weights already sit in the matching order.

Padding is XLA's ``"SAME"``, computed from the input size: with stride 2
on an even input it pads one more row and column at the bottom and right
(the 7×7/2 stem on 224: (2, 3); the 3×3/2 max pool on 112: (0, 1), filled
with −inf; each stride-2 3×3: (0, 1)).  ``nn.Conv2d(padding=3)`` and
``MaxPool2d(3, 2, padding=1)`` pad symmetrically: the same shapes,
different numbers.  The symmetric part goes to ``F.conv2d``'s own padding
and only the extra row and column to ``F.pad``.

The convolutions are cuDNN's: the reference computes them outside any
Pallas kernel, so no hand-written kernel stands behind this module.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["RESNET50_STAGES", "init_resnet50", "apply_resnet50",
           "resnet50_from_numpy"]

RESNET50_STAGES = (3, 4, 6, 3)


def _hwio(w_oihw: torch.Tensor) -> torch.Tensor:
    """The reference's HWIO view of an OIHW-contiguous conv weight."""
    return w_oihw.permute(2, 3, 1, 0)


def _stride(s: int, b: int) -> int:
    return 2 if (b == 0 and s > 0) else 1


def init_resnet50(generator_or_seed, num_classes: int = 1000,
                  device=None) -> dict:
    """Random ResNet-50 params in the reference's layout: fan-in normal
    conv weights (He), unit BN scales, zero BN and fc biases.  Drawn on the
    CPU from a ``torch.Generator`` (or a seed), then moved to ``device``
    (default: the card)."""
    dev = resolve_device(device)
    gen = generator_or_seed if isinstance(generator_or_seed,
                                          torch.Generator) \
        else torch.Generator().manual_seed(int(generator_or_seed))

    def conv(kh, kw, cin, cout):
        w = torch.randn((cout, cin, kh, kw), generator=gen) \
            * math.sqrt(2.0 / (kh * kw * cin))
        return _hwio(w.to(dev))

    def bn(c):
        return {"scale": torch.ones(c, device=dev),
                "bias": torch.zeros(c, device=dev)}

    params: dict = {"stem": conv(7, 7, 3, 64), "bn_stem": bn(64),
                    "stages": []}
    cin = 64
    for s, blocks in enumerate(RESNET50_STAGES):
        cmid = 64 * 2 ** s
        stage = []
        for b in range(blocks):
            cout = cmid * 4
            p = {"conv1": conv(1, 1, cin, cmid), "bn1": bn(cmid),
                 "conv2": conv(3, 3, cmid, cmid), "bn2": bn(cmid),
                 "conv3": conv(1, 1, cmid, cout), "bn3": bn(cout)}
            if _stride(s, b) != 1 or cin != cout:
                p["proj"] = conv(1, 1, cin, cout)
                p["bn_proj"] = bn(cout)
            stage.append(p)
            cin = cout
        params["stages"].append(stage)
    fc_w = torch.randn((cin, num_classes), generator=gen) \
        * math.sqrt(1.0 / cin)
    params["fc"] = {"w": fc_w.to(dev),
                    "b": torch.zeros(num_classes, device=dev)}
    return params


def resnet50_from_numpy(params_np: dict, device=None) -> dict:
    """The reference's params (numpy arrays, same nesting) as the port's:
    4-D conv weights stored OIHW-contiguous behind their HWIO view."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a, np.float32)
        if a.ndim == 4:
            return _hwio(torch.from_numpy(
                np.ascontiguousarray(a.transpose(3, 2, 0, 1))).to(dev))
        return torch.from_numpy(a.copy()).to(dev)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return leaf(t)

    return walk(params_np)


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, fill: float = 0.0):
    """``x`` with the asymmetric part of SAME padding applied, and the
    symmetric part left for the op: ``(x, (ph, pw))``."""
    (t, b), (l, r) = (_same_pads(x.shape[2], k, stride),
                      _same_pads(x.shape[3], k, stride))
    ph, pw = min(t, b), min(l, r)
    if (t, b, l, r) != (ph, ph, pw, pw):
        x = F.pad(x, (l - pw, r - pw, t - ph, b - ph), value=fill)
    return x, (ph, pw)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """SAME convolution, x NCHW, w the reference's HWIO."""
    x, pad = _pad_same(x, w.shape[0], stride)
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad)


def _bn(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x * p["scale"][:, None, None] + p["bias"][:, None, None]


def _bottleneck(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    y = F.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    y = F.relu(_bn(_conv(y, p["conv2"], stride), p["bn2"]))
    y = _bn(_conv(y, p["conv3"]), p["bn3"])
    if "proj" in p:
        x = _bn(_conv(x, p["proj"], stride), p["bn_proj"])
    return F.relu(x + y)


def _stem(params: dict, x: torch.Tensor) -> torch.Tensor:
    """7×7/2 conv, BN, ReLU, 3×3/2 max pool, each SAME-padded."""
    x = F.relu(_bn(_conv(x, params["stem"], 2), params["bn_stem"]))
    x, pad = _pad_same(x, 3, 2, fill=-math.inf)
    return F.max_pool2d(x, 3, 2, padding=pad)


def _trunk(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The four stages, the spatial mean and the dense head."""
    for s, stage in enumerate(params["stages"]):
        for b, block in enumerate(stage):
            x = _bottleneck(block, x, _stride(s, b))
    return x.mean(dim=(2, 3)) @ params["fc"]["w"] + params["fc"]["b"]


def apply_resnet50(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [N, 3, H, W] (NCHW, the paper's interface) → logits [N, classes]."""
    return _trunk(params, _stem(params, x))
