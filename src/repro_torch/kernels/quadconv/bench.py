"""Measurements of the QuadConv contraction kernel on the card.

Run by path from the repository root (it imports ``chip_smoke``'s timing
helpers and, for ``e2e``, its session functions from the tree it measures):

    python src/repro_torch/kernels/quadconv/bench.py kernel
    python src/repro_torch/kernels/quadconv/bench.py e2e --root DIR

``kernel`` times the kernel at the shapes the port runs (training's four
blocks at B = 4, a mesh rank's two at B = 2, serving's two at B = 8)
against its bytes bound: the shipped plan, one persistent block per SM
(with the device time of its split and sum kernels apart); the same plan
with runs of one item each (one block per item); the same plan with a
ring of 2 and 3 stages; plans with room for less staged f (shorter
chunks, a deeper ring); the shipped plan at B = 1 (the same bytes, an
eighth of the arithmetic at most); and ``torch.sum`` over G, PyTorch's
own read of the same bytes.  ``--quick``: the shipped plan and
``torch.sum`` only.  One JSON line per shape.

``e2e`` runs, with the tree at ``DIR`` (its ``src/`` and its
``chip_smoke.py``; default this tree), that tree's ``check_quadconv`` at
the five path shapes (its kernel's device time), the in-situ training
session of ``chip_smoke.py`` (8 epochs at 2,048 points, each epoch's
CUDA-event time) and a drained serving batch (the encoder at B = 8,
4,096 points, CUDA events), and prints one JSON line.  Run it for a
parent tree and this one in turns in one call to compare them on one
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[4]

# (B, I = J, C, O) and where the port runs it
SHAPES = [(4, 2048, 4, 16, "training encoder 0"),
          (4, 512, 16, 16, "training encoder 1 / decoder 0"),
          (4, 2048, 16, 16, "training decoder 1"),
          (8, 4096, 4, 16, "serving block 0"),
          (8, 1024, 16, 16, "serving block 1"),
          (2, 2048, 4, 16, "mesh rank encoder 0"),
          (2, 512, 16, 16, "mesh rank encoder 1 / decoder 0")]


def kernel_bench(cs, quick: bool = False) -> None:
    import torch

    from repro_torch.kernels.quadconv import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ops._LIB.load()
    for line in ops._LIB.build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            print(f"[build] {line.strip()}", flush=True)
    n_sm = ops._sm_count(torch.cuda.current_device())
    parts = {"split": "quadconv_contract_kernel",
             "sum": "quadconv_sum_kernel"}
    for B, I, C, O, where in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        f = torch.randn((B, I, C), generator=gen, device=dev)
        w = torch.rand((I,), generator=gen, device=dev) / I
        g = torch.randn((I, I, O, C), generator=gen, device=dev)
        want = ops.quadconv_contract(f, w, g, mode="ref")
        tol = 1e-4 * float(want.abs().max())
        bound, _ = cs.bound(4 * (g.numel() + f.numel() + w.numel()
                                 + B * I * O))
        plan = ops._split_plan(I, I, O, C, n_sm)
        row = {"shape": f"B={B} I=J={I} C={C} O={O}", "where": where,
               "bound_ms": bound}

        def measure(name, fn):
            err = float((fn() - want).abs().max())
            if not err <= tol:
                raise AssertionError(f"{name} at {row['shape']}: {err}")
            ms = cs.device_ms(fn, 20)
            row[name] = {"ms": ms, "wall_ms": cs.time_ms(fn, 20),
                         "bound_share": None if ms is None else bound / ms}

        def run(p, grid=None):
            return lambda: ops._launch(f, w, g, p, grid)

        measure("shipped", run(plan))
        row["shipped"]["plan"] = {"splits": plan.splits, "chunk": plan.chunk,
                                  "stages": plan.stages,
                                  "items": plan.items,
                                  "grid": plan.grid,
                                  "balance": plan.balance(n_sm)}
        row["shipped"]["parts_ms"] = cs.device_ms(run(plan), 20, parts)
        if not quick:
            # runs of one item each: the most blocks the plan allows (one
            # resident an SM, as its shared memory is), none persistent
            measure("one_block_per_item",
                    run(plan, plan.units // (plan.chunk // plan.rows)))
            for stages in (2, 3):       # a shallower ring, same plan
                measure(f"stages_{stages}",
                        run(dataclasses.replace(plan, stages=stages)))
            for fw in (2048, 1024):     # shorter chunks, a deeper ring
                p = ops._split_plan(I, I, O, C, n_sm, fw_floats=fw)
                measure(f"fw_{fw}", run(p))
                row[f"fw_{fw}"]["plan"] = {"splits": p.splits,
                                           "chunk": p.chunk,
                                           "stages": p.stages}
            one = f[:1].contiguous()
            row["b1_ms"] = cs.device_ms(
                lambda: ops._launch(one, w, g, plan), 20)
        row["torch_sum_of_g_ms"] = cs.device_ms(lambda: g.sum(), 20)
        print(json.dumps(row), flush=True)
        del f, w, g, want
        torch.cuda.empty_cache()


def e2e_bench(cs, root: str) -> None:
    from dataclasses import replace

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.quadconv import ops as qops
    from repro_torch.kernels.store import ops as sops
    from repro_torch.ml import autoencoder as ae
    from repro_torch.sim import flatplate as fp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    # the tree's own kernel check and times at the five path shapes
    contract_ms = {where: cs.check_quadconv(dev, B, I, C, O)["ms"]
                   for B, I, C, O, where in SHAPES[:5]}
    torch.cuda.empty_cache()
    cfg = ae.AEConfig(n_points=4096, channels=4, internal=16, latent=100,
                      blocks=2, pool=4, mlp_width=64, mlp_depth=5)
    # serving: a drained batch of 8 snapshots of 4,096 points
    fcfg = fp.FlatPlateConfig(nx=16, ny=16, nz=16)
    gen = torch.Generator().manual_seed(cs.SEED)
    params = ae.init_autoencoder(cfg, gen, dev)
    modes = fp.draw_modes(fcfg, gen, dev)
    coords = fp.grid_coords(fcfg, dev)
    levels = ae.coords_pyramid(cfg, coords)
    xs = torch.stack([fp.snapshot(fcfg, modes, s, coords)
                      for s in range(cs.MAX_BATCH)])
    torch.cuda.reset_peak_memory_stats()
    serve_ms = [cs.time_ms(lambda: ae.encode(params, cfg, levels,
                                             xs.transpose(1, 2)), 5)
                for _ in range(3)]
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del params, xs, levels
    torch.cuda.empty_cache()
    # in-situ training: chip_smoke's session, 8 epochs at 2,048 points
    tfcfg = fp.FlatPlateConfig(nx=16, ny=16, nz=8)
    tcfg = replace(cfg, n_points=tfcfg.n_points)
    counters = [sops.PROBE, sops.SAMPLE, sops.GATHER, qops.QUADCONV]
    run = cs.train_session(dev, tcfg, tfcfg, True, counters,
                           label="e2e")
    print(json.dumps({"root": root, "contract_ms": contract_ms,
                      "epoch_ms": run["epoch_ms"],
                      "train_peak_gb": run["peak_gb"],
                      "quadconv_launches":
                          run["launches"]["quadconv_contract"],
                      "serve_batch_ms": serve_ms,
                      "serve_peak_gb": serve_peak}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("kernel", "e2e"))
    parser.add_argument("--quick", action="store_true",
                        help="kernel: the shipped plan and torch.sum only")
    parser.add_argument("--root", default=str(_REPO),
                        help="tree to measure (its src/ and chip_smoke.py)")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if args.mode == "kernel":
        kernel_bench(cs, args.quick)
    else:
        e2e_bench(cs, str(root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
