"""Quickstart on the PyTorch port: the declarative in-situ coupling API.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of ``examples/quickstart.py`` on ``repro_torch``: declare *what*
runs (a producer and a trainer plus their table) as one
``InSituSession``, ask the plan how it *will* run, then run it on the
card (``--device cpu`` for the plain PyTorch path).  The raw
SmartRedis-style verbs remain available underneath for control-plane
traffic (shown at the end).
"""

import argparse

import torch

from repro_torch.core import Client, StoreServer, TableSpec
from repro_torch.core.store import make_key
from repro_torch.device import resolve_device
from repro_torch.insitu import InSituSession, Producer, TrainerConsumer
from repro_torch.ml import autoencoder as ae
from repro_torch.ml import trainer as tr
from repro_torch.sim import flatplate as fp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--sim-steps", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. declare the whole workflow: tables + components ----------------
    fcfg = fp.FlatPlateConfig(nx=8, ny=8, nz=4)
    modes = fp.draw_modes(fcfg, torch.Generator().manual_seed(0), dev)
    coords = fp.grid_coords(fcfg, dev)

    def sim_step(carry, rank, t):
        """One solver step: advance, return (carry, key, snapshot)."""
        return carry, make_key(rank, t), fp.snapshot(fcfg, modes, t, coords)

    cfg = tr.TrainerConfig(
        ae=ae.AEConfig(n_points=fcfg.n_points, latent=16, mlp_width=16),
        epochs=args.epochs, gather=6, batch_size=4, lr=1e-3)
    session = InSituSession(
        tables=[TableSpec("field", shape=(4, fcfg.n_points), capacity=16,
                          engine="ring")],
        components=[
            Producer(sim_step, table="field", steps=args.sim_steps,
                     carry=torch.zeros((), device=dev), emit_every=2),
            TrainerConsumer(cfg, coords, model_key="encoder"),
        ], device=dev)

    # --- 2. the plan says HOW it will run (tiers, predicted dispatches) ----
    plan = session.plan()
    print(plan.describe())
    print("predicted store dispatches:", plan.store_dispatches)

    # --- 3. run it: producer thread + trainer thread, coupled via the store
    result = session.run(plan=plan, max_wall_s=300)
    assert result.ok, result.run.components
    trained = result.output("trainer")
    print(f"trained {trained.steps} epochs, "
          f"final val relF {trained.history[-1].val_rel_error:.3f}")
    print("measured store dispatches:", result.server.stats()["op_count"])

    # --- 4. in-situ inference with the registered model --------------------
    client = result.client()
    mu, sd = client.get_metadata("norm_stats")
    x = (fp.snapshot(fcfg, modes, 99, coords).T - mu) / sd
    z = client.infer("encoder", x)                  # one registry call
    print("encoded latent:", tuple(z.shape))

    # --- 5. the per-verb layer underneath (SmartRedis-style) ---------------
    server = StoreServer(device=dev)
    server.create_table(TableSpec("named", shape=(4,), capacity=16,
                                  engine="hash"))
    sim, ml = Client(server, rank=0), Client(server, rank=1)
    sim.put_tensor("bc.inflow", torch.tensor([1.0, 0.0, 0.0, 0.5]),
                   table="named")
    val, found = ml.get_tensor("bc.inflow", table="named")
    print("named tensor roundtrip:", bool(found), val.tolist())
    sim.put_metadata("re_tau", 400.0)
    print("metadata:", ml.get_metadata("re_tau"))

    print("\ncomponent timers:")
    print(result.timers.table())


if __name__ == "__main__":
    main()
