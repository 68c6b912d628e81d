"""In-situ driver launcher (the paper's §2.2 "driver program").

Port of ``src/repro/launch/insitu.py``.  ``python -m
repro_torch.launch.insitu`` wires the paper's workflow as ONE
:class:`~repro_torch.insitu.InSituSession` on one device (the card by
default, ``--device cpu`` for the plain PyTorch path): a simulation puts
solution snapshots into the ring table ``"field"`` — the synthetic
flat-plate generator, or with ``--producer spectral`` the pseudo-spectral
Navier-Stokes solver (``sim/spectral.py`` on ``torch.fft``, a 16³ forced
box from random turbulence, each snapshot sliced or tiled to the grid's
point count) — the QuadConv-autoencoder trainer consumes them, and an
in-situ inference component encodes later flat-plate snapshots with the
freshly trained encoder.  Prints the resolved plan, one line per epoch
and the paper-Tables-1/2-style overhead report.

Where it differs from the reference: the reference pins the QuadConv
oracle (``mode="ref"``); here the contraction runs the hand-written
kernel on the card.  The inference ``feed`` returns one element
``[N, C]`` (the registry adds the batch axis).  The producer ranks'
random draws (flat-plate modes, the spectral solver's start) and the
inference snapshots' modes come from a ``torch.Generator`` seeded with
``seed``, where the reference folds the rank into a JAX key.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..core import TableSpec
from ..core import store as S
from ..core.orchestrator import StragglerPolicy
from ..device import resolve_device
from ..insitu import (InferenceConsumer, InSituSession, Producer,
                      TrainerConsumer)
from ..ml import autoencoder as ae
from ..ml import trainer as tr
from ..sim import flatplate as fp
from ..sim import spectral as sp
from ..tree import tree_map

__all__ = ["make_producer", "run", "main"]


def make_producer(*, sim_steps: int, producer: str, fcfg, ncfg=None,
                  send_every: int, compute_s: float, seed: int,
                  producers: int, device=None) -> Producer:
    """Declare the simulation producer for the session.

    With ``compute_s > 0`` the solver cost is emulated with a sleep, and
    the declaration carries ``traceable=False`` so the plan pins the
    per-verb tier, as in the reference.  Otherwise the plan captures whole
    chunks of steps and their ring puts per store op.  ``ncfg`` is the
    spectral solver's config, which only the spectral producer reads: one
    ``random_turbulence`` start per rank (stacked on a leading axis for
    ``producers > 1``), one RK4 step a simulation step, its snapshot
    sliced or tiled to ``fcfg.n_points``.
    """
    if producer not in ("flatplate", "spectral"):
        raise ValueError(f"unknown producer {producer!r}")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    n_points = fcfg.n_points

    def _fit_points(snap3):
        # the spectral grid's n³ points, re-tiled to n_points
        if snap3.shape[1] >= n_points:
            return snap3[:, :n_points]
        return snap3.repeat(1, n_points // snap3.shape[1] + 1)[:, :n_points]

    if producer == "spectral":
        if ncfg is None:
            raise ValueError("the spectral producer needs its NSConfig")
        starts = [sp.random_turbulence(ncfg, sp.draw_noise(ncfg, gen, dev))
                  for _ in range(producers)]
        carry = starts[0] if producers == 1 \
            else tree_map(lambda *xs: torch.stack(xs), *starts)

        def step_fn(carry, rank, t):
            if compute_s:
                time.sleep(compute_s)          # per-verb tier only
            carry = sp.step(ncfg, carry)
            return carry, S.make_key(rank, t), \
                _fit_points(sp.snapshot(ncfg, carry))
    else:
        modes = [fp.draw_modes(fcfg, gen, dev) for _ in range(producers)]
        coords = fp.grid_coords(fcfg, dev)
        carry = torch.zeros((), device=dev) if producers == 1 \
            else torch.zeros((producers,), device=dev)

        def step_fn(carry, rank, t):
            if compute_s:
                time.sleep(compute_s)          # per-verb tier only
            return carry, S.make_key(rank, t), \
                fp.snapshot(fcfg, modes[rank], t, coords)

    return Producer(step_fn, table="field", steps=sim_steps,
                    ranks=producers, carry=carry, emit_every=send_every,
                    traceable=(compute_s == 0))


def run(epochs: int = 40, sim_steps: int = 200, points: str = "small",
        producer: str = "flatplate", send_every: int = 2,
        capacity: int = 24, gather: int = 6, latent: int = 16,
        lr: float = 1e-3, compute_s: float = 0.0, seed: int = 0,
        producers: int = 1, consumers: int = 1, verbose: bool = True,
        device=None):
    """Run the paper's workflow once on ``device`` (default: the card).

    ``compute_s``: emulated PDE-integration cost per step (pins the
    per-verb producer and trainer).  ``producers``: simulation ranks
    sharing the fused capture; ``consumers``: trainer replicas, each on its
    own disjoint slice of the visible cards (``disjoint_data_meshes``; a
    slice of one card trains in the ``fused`` tier).
    ``points``: ``"small"`` (8×8×4 = 256 points) or ``"medium"``
    (16×16×8 = 2,048).
    """
    if producers > 1 and compute_s:
        raise ValueError("multi-producer capture requires the fused tier "
                         "(compute_s == 0)")
    dev = resolve_device(device)
    if points == "small":
        fcfg = fp.FlatPlateConfig(nx=8, ny=8, nz=4)
    else:
        fcfg = fp.FlatPlateConfig(nx=16, ny=16, nz=8)
    coords = fp.grid_coords(fcfg, dev)
    n_points = fcfg.n_points

    cfg = tr.TrainerConfig(
        ae=ae.AEConfig(n_points=n_points, latent=latent, mlp_width=16),
        epochs=epochs, gather=gather, batch_size=4, lr=lr,
        # paper-comparison runs (emulated solver cost) measure the
        # per-verb consumer so "retrieve" means what Table 2 means
        fused=(compute_s == 0))
    ncfg = sp.NSConfig(n=16, nu=0.02, dt=0.01, forcing=True)
    prod = make_producer(sim_steps=sim_steps, producer=producer, fcfg=fcfg,
                         ncfg=ncfg, send_every=send_every,
                         compute_s=compute_s, seed=seed, producers=producers,
                         device=dev)
    inf_modes = fp.draw_modes(fcfg, torch.Generator().manual_seed(seed + 1),
                              dev)

    def feed(client, step):
        """Encode post-training snapshots (the in-situ inference phase):
        one standardised element [N, C]."""
        mu, sd = client.get_metadata("norm_stats")
        snap = fp.snapshot(fcfg, inf_modes, sim_steps + step, coords)
        return (snap.T - mu) / sd

    session = InSituSession(
        tables=[TableSpec("field", shape=(4, n_points), capacity=capacity,
                          engine="ring")],
        components=[
            prod,
            TrainerConsumer(cfg, coords, count=consumers,
                            model_key="encoder"),
            InferenceConsumer("encoder", feed, steps=5,
                              wait_meta="trained"),
        ],
        straggler=StragglerPolicy(consumer_wait_s=30.0), device=dev)

    plan = session.plan()
    if verbose:
        print(plan.describe(), "\n")
    res = session.run(plan=plan, max_wall_s=3600, verbose=verbose)
    if not res.ok:
        raise RuntimeError({n: c.error for n, c in
                            res.run.components.items() if c.error})

    # --- report (paper Tables 1-2 analogue) -------------------------------
    inf = res.output(plan.components[-1].name)
    timers = res.run.timers
    if inf is not None and inf.last is not None:
        cf = ae.compression_factor(cfg.ae)
        t_inf = timers.mean("model_eval") or 0.0
        print(f"\nin-situ inference: latent {tuple(inf.last.shape)}, "
              f"compression {cf:.0f}x, {t_inf*1e3:.1f}ms/snapshot")
    print("\n" + timers.table("In-situ component overheads "
                              "(paper Tables 1-2 analogue)"))
    sol = timers.total("equation_solution")
    send = timers.total("send")
    tr_total = timers.total("total_training")
    retr = timers.total("retrieve")
    if sol:
        print(f"\nsend overhead / solver time: {100*send/sol:.2f}% "
              f"(paper: <<1%)")
    if tr_total:
        print(f"retrieve overhead / training time: {100*retr/tr_total:.2f}% "
              f"(paper: ~1%)")
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--sim-steps", type=int, default=200)
    ap.add_argument("--producer", choices=["flatplate", "spectral"],
                    default="flatplate")
    ap.add_argument("--points", choices=["small", "medium"], default="small")
    ap.add_argument("--producers", type=int, default=1,
                    help="simulation ranks sharing the fused capture")
    ap.add_argument("--consumers", type=int, default=1,
                    help="trainer replicas, each on its own slice of the "
                    "visible cards (one card: fused replicas)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    run(epochs=args.epochs, sim_steps=args.sim_steps,
        producer=args.producer, points=args.points,
        producers=args.producers, consumers=args.consumers,
        device=args.device)


if __name__ == "__main__":
    main()
