"""END-TO-END DRIVER (paper §4) on the PyTorch port: in-situ training of
the QuadConv autoencoder from a live flow simulation, then in-situ
inference.

Run:  PYTHONPATH=src python examples/torch_insitu_autoencoder.py \
          [--epochs 150] [--producer spectral] [--device cpu]

The twin of ``examples/insitu_autoencoder.py`` on ``repro_torch``, as one
declarative session on the card (``--device cpu`` for the plain PyTorch
path): a producer streaming synthetic turbulent flat-plate snapshots (or
``--producer spectral`` for the pseudo-spectral Navier-Stokes solver on
``torch.fft``) into the store, the QuadConv autoencoder trainer consuming
them, and an inference component encoding post-training snapshots with
the freshly registered encoder.  The session's plan picks the fused tiers
and the run prints the Tables-1/2-style overhead report.
"""

import argparse

import torch

from repro_torch.core import TableSpec
from repro_torch.core.store import make_key
from repro_torch.device import resolve_device
from repro_torch.insitu import (InferenceConsumer, InSituSession, Producer,
                                TrainerConsumer)
from repro_torch.ml import autoencoder as ae
from repro_torch.ml import trainer as tr
from repro_torch.sim import flatplate as fp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--sim-steps", type=int, default=400)
    ap.add_argument("--latent", type=int, default=16)
    ap.add_argument("--producer", choices=["flatplate", "spectral"],
                    default="flatplate")
    ap.add_argument("--points", choices=["small", "medium"], default="small")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.producer == "spectral" or args.points == "medium":
        # the launcher knows how to build the fancier producers
        from repro_torch.launch.insitu import run
        run(epochs=args.epochs, sim_steps=args.sim_steps,
            latent=args.latent, producer=args.producer, points=args.points,
            device=dev)
        return

    fcfg = fp.FlatPlateConfig(nx=8, ny=8, nz=4)
    modes = fp.draw_modes(fcfg, torch.Generator().manual_seed(0), dev)
    coords = fp.grid_coords(fcfg, dev)
    cfg = tr.TrainerConfig(
        ae=ae.AEConfig(n_points=fcfg.n_points, latent=args.latent,
                       mlp_width=16),
        epochs=args.epochs, gather=6, batch_size=4, lr=1e-3)

    def sim_step(carry, rank, t):
        return carry, make_key(rank, t), fp.snapshot(fcfg, modes, t, coords)

    def feed(client, step):
        mu, sd = client.get_metadata("norm_stats")
        snap = fp.snapshot(fcfg, modes, args.sim_steps + step, coords)
        return (snap.T - mu) / sd

    session = InSituSession(
        tables=[TableSpec("field", shape=(4, fcfg.n_points), capacity=24,
                          engine="ring")],
        components=[
            Producer(sim_step, table="field", steps=args.sim_steps,
                     carry=torch.zeros((), device=dev), emit_every=2),
            TrainerConsumer(cfg, coords, model_key="encoder"),
            InferenceConsumer("encoder", feed, steps=5),
        ], device=dev)
    print(session.plan().describe(), "\n")
    result = session.run(max_wall_s=3600, verbose=True)
    assert result.ok, result.run.components
    z = result.output("inference").last
    cf = ae.compression_factor(cfg.ae)
    print(f"\nin-situ inference: latent {tuple(z.shape)}, compression "
          f"{cf:.0f}x")
    print("\n" + result.timers.table(
        "In-situ component overheads (paper Tables 1-2 analogue)"))


if __name__ == "__main__":
    main()
