"""LM training example on the PyTorch port: train a ~100M-param dense model
on the synthetic structured corpus, with checkpoint/restart and in-situ
hidden-state capture.

Run:  PYTHONPATH=src python examples/torch_lm_train.py [--steps 300] \
          [--device cpu] [--smoke]

The twin of ``examples/lm_train.py`` on ``repro_torch``.  The model is the
StarCoder2 family at ~100M scale (8 layers, d=512), registered with the
config registry under a local name the way the reference's example does:
a module ``repro_torch.configs.starcoder2_100m`` placed in
``sys.modules``.  The corpus has a deterministic next-token rule, so the
loss falls.  Halfway through, the run "crashes" and restarts from the
latest durable checkpoint (``train.checkpoint.Checkpointer``, staged
through host memory).  The port's launcher resumes at the restored step
(the reference's starts its loop again at 0).  ``--smoke`` registers a
2-layer, d=64 model of the same family for a quick run.
"""

import argparse
import shutil
import sys
import tempfile
import types

import torch

from repro_torch.launch.train import run
from repro_torch.models.config import ModelConfig


def config_100m() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-100m", family="dense",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=2,
        d_ff=2048, vocab=8192,
        pattern=(("attn", "mlp"),), mlp_act="gelu", norm="layernorm",
        attn_chunk=256, remat=False, dtype=torch.float32)


def smoke_100m() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-100m-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512,
        pattern=(("attn", "mlp"),), mlp_act="gelu", norm="layernorm",
        attn_chunk=64, remat=False, dtype=torch.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="a 2-layer, d=64 model of the same family")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # register the 100M config under a local name
    mod = types.ModuleType("repro_torch.configs.starcoder2_100m")
    mod.config = config_100m
    mod.smoke_config = smoke_100m
    sys.modules["repro_torch.configs.starcoder2_100m"] = mod

    ckpt_dir = tempfile.mkdtemp(prefix="lm100m_ckpt_")
    kw = dict(batch=args.batch, seq_len=args.seq_len, smoke=args.smoke,
              ckpt_dir=ckpt_dir, ckpt_every=50, device=args.device)
    try:
        half = args.steps // 2
        print(f"=== phase 1: train {half} steps (checkpoint every 50) ===")
        first = run("starcoder2_100m", steps=half, capture=True, **kw)
        print("\n=== simulated failure; phase 2: restart from checkpoint ===")
        second = run("starcoder2_100m", steps=args.steps, resume=True, **kw)
        assert second.start == half, (second.start, half)
        print(f"loss {first.losses[0]:.3f} -> {second.losses[-1]:.3f} over "
              f"{args.steps} steps, resumed at step {second.start}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
