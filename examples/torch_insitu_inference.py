"""In-situ inference (paper §3.2 + Fig. 1b) on the PyTorch port: a
simulation evaluates an ML model through the store at runtime, staying
agnostic of its structure.

Run:  PYTHONPATH=src python examples/torch_insitu_inference.py \
          [--batch 2] [--iters 5] [--device cpu]

The twin of ``examples/insitu_inference.py`` on ``repro_torch``:

* Loads ResNet-50 (the paper's benchmark model, random weights from a
  seed) into the model registry.  The port's registry calls a model on a
  batch of stored elements, and one stored element here is a whole image
  batch, so the model is registered through ``fold_registry_axis``.
* Declares the same ``InferenceConsumer`` twice, once forced onto the
  paper's three-step protocol (put → run_model → get) and once on the
  fused registry tier, and lets the session plan run each.
* Compares both against the in-line call, Fig. 7's trade-off.

``--image`` shrinks the input's sides (224 by default) for a quick run.
"""

import argparse

import torch

from repro_torch.core.telemetry import Timers, block_until_ready
from repro_torch.device import resolve_device
from repro_torch.insitu import InferenceConsumer, InSituSession
from repro_torch.ml.resnet import apply_resnet50, init_resnet50
from repro_torch.sim.reproducer import fold_registry_axis


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("initializing ResNet-50 (paper's inference benchmark model)...")
    params = init_resnet50(0, device=dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((args.batch, 3, args.image, args.image),
                    generator=gen).to(dev)

    def run_tier(tier: str) -> Timers:
        session = InSituSession(components=[
            InferenceConsumer("resnet50", lambda client, step: x,
                              steps=args.iters, wait_meta=None, tier=tier),
        ], device=dev)
        # no trainer in this session: preload the model into the registry
        result = session.run(max_wall_s=600, sequential=True,
                             preload=lambda server: server.set_model(
                                 "resnet50",
                                 fold_registry_axis(apply_resnet50), params))
        assert result.ok, result.run.components
        return result.timers

    print(f"\n-- three-step protocol (paper Fig. 1b), batch={args.batch} --")
    timers = run_tier("three_step")
    print(timers.table())

    print("\n-- fused registry path (a single dispatch) --")
    timers_fused = run_tier("fused_registry")
    print(timers_fused.table())

    print("\n-- in-line baseline (the tightly-coupled call) --")
    t = Timers()
    block_until_ready(apply_resnet50(params, x))
    for _ in range(args.iters):
        with t.time("inline_eval") as box:
            box[0] = apply_resnet50(params, x)
    print(t.table())

    total_3step = (timers.mean("send") + timers.mean("model_eval")
                   + timers.mean("retrieve"))
    print(f"\n3-step total {total_3step*1e3:.1f} ms vs in-line "
          f"{t.mean('inline_eval')*1e3:.1f} ms "
          f"({total_3step/t.mean('inline_eval'):.2f}x — paper saw 2–4.6x) "
          f"vs fused {timers_fused.mean('model_eval')*1e3:.1f} ms")


if __name__ == "__main__":
    main()
