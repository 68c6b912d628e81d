"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Port of ``src/repro/launch/train.py`` on one device: weights from
``seed`` (``init_train_state``), the background-prefetched synthetic
token stream (``data.pipeline``), ``launch.steps.make_train_step``, a
step-time watchdog that logs stragglers, and optional in-situ capture
(``--capture``: every 4th step sends a [batch, d_model] zero block into
a ring table through ``Client.send_step``, as the reference does).

As in the reference, the state is initialised with ``make_tx(cfg,
total_steps=steps)`` but the step builds its own ``make_tx(cfg)`` with
the default 100,000-step schedule: its first learning rate is
3e-4 / 2000 = 1.5e-7 (``ROADMAP.md`` §C).

Runs on the card by default (``--device cpu`` for the plain PyTorch path)
and at the config's full width (``--full`` spells that default out);
``--smoke`` takes the reduced same-family config (the reference's
launcher defaults to it and takes ``--full`` for the other).  ``attn_impl`` overrides the config's
attention plan (``"flash"``: the hand-written forward and backward
kernels).  Training MoE, vision and encoder-decoder models is
``ROADMAP.md`` A7 (``steps.untrainable``).

Durable checkpoints go through ``train.checkpoint.Checkpointer``, in the
reference's on-disk layout: with ``--ckpt-dir`` the state is saved every
``--ckpt-every`` steps and after the last one (the three newest kept);
``ckpt_every`` is read only with a ``ckpt_dir``, as in the reference.
``--resume`` restores the latest checkpoint there, into the freshly
initialised state in place.  Unlike the
reference, whose loop and token stream start again at 0 after a resume,
a resumed run continues at the restored step up to ``--steps`` in all,
past the token stream's consumed batches, so its steps are bit for bit
the uninterrupted run's.
"""

from __future__ import annotations

import argparse
import itertools
import time
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from ..configs.registry import get_config, get_smoke_config
from ..core import Client, StoreServer, TableSpec
from ..data.pipeline import PrefetchIterator, TokenStream
from ..device import resolve_device
from ..train import checkpoint as ckpt
from ..train.train_state import TrainState, init_train_state, make_tx
from .steps import make_train_step, model_specs, untrainable

__all__ = ["TrainRun", "run", "parser", "main"]


class TrainRun(NamedTuple):
    state: TrainState
    losses: list[float]
    grad_norms: list[float]
    step_s: list[float]            # wall time of each step (synchronised)
    tokens_per_s: float            # over the steps run, their wall time
    server: StoreServer | None     # the capture store, with --capture
    start: int = 0                 # the first step run (> 0 on a resume)


def run(arch: str, steps: int = 50, batch: int = 4, seq_len: int = 64,
        smoke: bool = False, ckpt_dir: str | None = None,
        ckpt_every: int = 20, resume: bool = False, capture: bool = False,
        seed: int = 0, log_every: int = 10, straggler_factor: float = 3.0,
        *, device=None, attn_impl: str | None = None) -> TrainRun:
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if attn_impl is not None:
        cfg = replace(cfg, attn_impl=attn_impl)
    why = untrainable(cfg)
    if why:
        raise NotImplementedError(f"{cfg.name}: {why} is ROADMAP.md A7")
    specs = model_specs(cfg)
    tx = make_tx(cfg, total_steps=steps)
    state = init_train_state(torch.Generator(device=dev).manual_seed(seed),
                             cfg, specs, tx, device=dev)

    checkpointer, start = None, 0
    if ckpt_dir:
        checkpointer = ckpt.Checkpointer(ckpt_dir, interval_steps=ckpt_every)
        if resume and ckpt.latest_step(ckpt_dir) is not None:
            state = ckpt.restore(ckpt_dir, state)
            start = int(state.step)
            print(f"resumed from step {start}")

    server = client = None
    if capture:
        server = StoreServer(device=dev)
        server.create_table(TableSpec("hidden", shape=(batch, cfg.d_model),
                                      capacity=32, dtype=torch.float32,
                                      engine="ring"))
        client = Client(server)

    step_fn = make_train_step(cfg)
    # a resumed run skips the batches its restored steps consumed
    stream = PrefetchIterator(itertools.islice(
        iter(TokenStream(cfg.vocab, batch, seq_len, seed=seed)), start,
        None), buffer_size=2, device=dev)
    times: list[float] = []
    losses: list[float] = []
    norms: list[float] = []
    try:
        for i, batch_dev in zip(range(start, steps), stream):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_dev)
            losses.append(float(metrics["loss"]))    # waits for the step
            dt = time.perf_counter() - t0
            times.append(dt)
            norms.append(float(metrics["grad_norm"]))
            # straggler watchdog
            if len(times) > 5 and dt > straggler_factor * float(
                    np.median(times)):
                print(f"[straggler] step {i}: {dt*1e3:.1f}ms vs median "
                      f"{np.median(times)*1e3:.1f}ms")
            if capture and i % 4 == 0:
                client.send_step("hidden", i, torch.zeros(
                    (batch, cfg.d_model), device=dev))
            if checkpointer is not None:
                checkpointer.maybe_save(i + 1, state)
            if i % log_every == 0:
                print(f"step {i:5d} loss {losses[-1]:.4f} "
                      f"ce {float(metrics['ce']):.4f} {dt*1e3:.0f}ms")
    finally:
        stream.close()
    if checkpointer is not None:
        checkpointer.maybe_save(steps, state, force=True)
        checkpointer.close()
        if checkpointer.errors:
            raise RuntimeError(f"checkpoint writes failed: "
                               f"{checkpointer.errors}")
    wall = sum(times)
    if times:
        print(f"done: {len(times)} steps in {wall:.1f}s; loss "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    return TrainRun(state, losses, norms, times,
                    len(times) * batch * seq_len / wall if times else 0.0,
                    server, start)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    width = ap.add_mutually_exclusive_group()
    width.add_argument("--smoke", action="store_true",
                       help="the reduced same-family config (CPU-sized)")
    width.add_argument("--full", action="store_true",
                       help="the full-width config (the default)")
    ap.add_argument("--attn-impl", default=None,
                    help="override the config's attention plan "
                         "('flash': the hand-written kernels)")
    ap.add_argument("--capture", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save durable checkpoints here (train/checkpoint.py;"
                         " the three newest are kept)")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="steps between saves (with --ckpt-dir; the last "
                         "step is always saved)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir,"
                         " up to --steps in all")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv: list[str] | None = None) -> TrainRun:
    args = parser().parse_args(argv)
    return run(args.arch, steps=args.steps, batch=args.batch,
               seq_len=args.seq_len, smoke=args.smoke,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               resume=args.resume, capture=args.capture, seed=args.seed,
               log_every=args.log_every, device=args.device,
               attn_impl=args.attn_impl)


if __name__ == "__main__":
    main()
