"""Mixture-of-Experts FFN: token-choice top-k routing with capacity.

Port of ``src/repro/models/moe.py`` on one device (the reference's
``shard`` layout hints have no counterpart here):

  1. router logits in fp32 → softmax → top-k experts per token, gates
     renormalized;
  2. slot assignment: position-in-expert by a cumulative count over the
     (token, choice) axis, token-major with the k choices inner; pairs
     beyond ``capacity = ceil(S·k/E · capacity_factor)`` are dropped;
  3. dispatch: token vectors scatter-ADDED into per-expert buffers of C
     slots (a dropped pair adds a zero row to its expert's slot C-1,
     which a kept pair may own);
  4. expert compute: batched matmuls over the expert axis;
  5. combine: gather back per (token, choice), weight by the gates, sum
     the k copies.

The buffers are laid out ``[E, B, C, D]`` (the reference's ``[B, E, C,
D]`` with the expert axis first), so each expert's rows are one
contiguous block of the ``bmm``.  Two choices follow the reference where
torch's defaults differ: the router's product is taken from the
model-dtype values upcast to fp32 (the reference's
``preferred_element_type=float32``; a bf16 product cast afterwards would
round the logits first), and the top k come from a stable descending
sort, so that among equal probabilities the lower expert index comes
first as ``jax.lax.top_k`` returns it (``torch.topk`` promises no order).

Auxiliary load-balance loss (Switch-style): ``E · Σ_e f_e·P_e`` with f
the routed fraction and P the mean router probability, in fp32.  A
Llama-4-style always-on shared expert is ``cfg.shared_expert``.

Under autograd the layer's gradients are ``jax.grad``'s of the
reference's: to the router through the renormalized gates (the sort's
backward sends each gate's gradient to the probability it took, as
``lax.top_k``'s JVP does) and through the aux term's mean probability
(the routed fraction is a count, with none), to the experts through the
``bmm``s, to x through the dispatch, the router and the shared expert.
The dispatch is an out-of-place ``index_add`` and the combine a gather,
so a dropped pair's zero-weighted row adds to slot C-1's gradient and
never overwrites it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import ParamSpec
from .layers import mlp_apply, mlp_specs

__all__ = ["Routing", "capacity", "moe_specs", "route", "moe_apply"]


def capacity(cfg, tokens_per_group: int) -> int:
    cap = math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                    * cfg.capacity_factor)
    return max(8, min(cap, tokens_per_group))


def moe_specs(cfg, stacked: tuple[int, ...] = ()) -> dict:
    D = cfg.d_model
    F_ = cfg.d_ff_moe or cfg.d_ff
    E = cfg.n_experts
    lay = ("layers",) * len(stacked)
    p = {
        "router": ParamSpec(stacked + (D, E), lay + ("embed", None)),
        "w_up": ParamSpec(stacked + (E, D, F_),
                          lay + ("expert", "embed", "mlp")),
        "w_down": ParamSpec(stacked + (E, F_, D),
                            lay + ("expert", "mlp", "embed")),
    }
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = ParamSpec(stacked + (E, D, F_),
                                lay + ("expert", "embed", "mlp"))
    if cfg.shared_expert:
        p["shared"] = mlp_specs(D, F_, cfg.mlp_act, stacked)
    return p


class Routing(NamedTuple):
    """One MoE layer's routing of x [B, S, D] (k choices a token)."""
    probs: torch.Tensor       # [B, S, E] fp32 router probabilities
    gates: torch.Tensor       # [B, S, k] fp32, renormalized
    expert_idx: torch.Tensor  # [B, S, k] int64, descending probability
    keep: torch.Tensor        # [B, S·k] bool: the pair got a slot
    dest: torch.Tensor        # [B, S·k] row of the pair in [E·B·C]
    capacity: int


def route(params: dict, cfg, x: torch.Tensor) -> Routing:
    """Router, top-k and slot assignment (steps 1-2)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :k], idx[..., :k]
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                    min=1e-9)
    flat_e = expert_idx.reshape(B, S * k)
    counts = torch.cumsum(F.one_hot(flat_e, E), dim=1)
    pos = torch.gather(counts, 2, flat_e[..., None])[..., 0] - 1
    keep = pos < C
    batch = torch.arange(B, device=x.device)[:, None]
    dest = (flat_e * B + batch) * C + torch.clamp(pos, 0, C - 1)
    return Routing(probs, gates, expert_idx, keep, dest, C)


def _experts(params: dict, cfg, buf: torch.Tensor) -> torch.Tensor:
    """buf [E, rows, D] → [E, rows, D] through each expert's MLP."""
    h = torch.bmm(buf, params["w_up"])
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.bmm(buf, params["w_gate"])) * h
    elif cfg.mlp_act == "gelu":
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    elif cfg.mlp_act == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown activation {cfg.mlp_act!r}")
    return torch.bmm(h, params["w_down"])


def moe_apply(params: dict, cfg, x: torch.Tensor,
              routing: Routing | None = None):
    """x: [B, S, D] → (y [B, S, D], aux fp32 0-d).  ``routing`` defaults
    to ``route(params, cfg, x)``; a caller that needs the routing passes
    the one it holds."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    r = routing if routing is not None else route(params, cfg, x)
    C = r.capacity

    # ---- dispatch: added, never assigned (see the module docstring) ----
    x_rep = x.repeat_interleave(k, dim=1) * r.keep[..., None].to(x.dtype)
    buf = torch.zeros((E * B * C, D), dtype=x.dtype, device=x.device) \
        .index_add(0, r.dest.reshape(-1), x_rep.reshape(B * S * k, D))
    del x_rep

    # ---- expert compute and combine ----
    y_buf = _experts(params, cfg, buf.view(E, B * C, D)).view(E * B * C, D)
    weight = r.gates.reshape(B, S * k).to(x.dtype) * r.keep.to(x.dtype)
    y_tok = y_buf[r.dest.reshape(-1)].view(B, S * k, D) * weight[..., None]
    y = y_tok.view(B, S, k, D).sum(dim=2)

    # ---- Switch-style load-balance auxiliary loss ----
    flat_e = r.expert_idx.reshape(B, S * k)
    routed = F.one_hot(flat_e, E).float().mean(dim=(0, 1))
    frac_routed = routed * S * k / S
    mean_prob = r.probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_routed / k * mean_prob)

    if cfg.shared_expert:
        y = y + mlp_apply(params["shared"], x, cfg.mlp_act)
    return y, aux
