"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Port of ``src/repro/launch/serve.py``: the continuous-batching serve loop
(``serve.decode.serve_loop``) over random prompts, with weights made from
``seed`` by ``init_params`` on the device, for every id the registry
carries (dense, MoE, Mamba-2, the Jamba hybrid; a vision config serves
its text backbone, as the reference's launcher does: the loop feeds
tokens only; an encoder-decoder config is refused with the reference's
``SystemExit``: Whisper serves through ``launch.steps.make_prefill_step``
and ``make_decode_step``).  Runs on the card by default
(``--device cpu`` for the plain PyTorch path) and at the config's full
width; ``--smoke`` takes the reduced same-family config (the reference's
launcher runs only that one: its full-width path lowers the production
decode step for its mesh dry-run instead).  ``--capture`` registers the
model in the store's registry and streams every 8th step's logits into a
ring table through ``Client.send_step`` — the paper's in-situ inference
integration.  The prompts are drawn from a ``torch.Generator`` seeded
with ``seed + 1`` (JAX's draws cannot be reproduced).
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..configs.registry import get_config, get_smoke_config
from ..core import Client, StoreServer, TableSpec
from ..device import resolve_device
from ..models import lm
from ..parallel.sharding import init_params
from ..serve.batching import Batcher
from ..serve.decode import serve_loop
from .steps import model_specs

__all__ = ["ServeRun", "run", "main"]


class ServeRun(NamedTuple):
    completed: list
    steps: int
    tokens_per_s: float
    wall_s: float
    server: StoreServer | None     # the capture store, with --capture


def run(arch: str, n_requests: int = 8, batch: int = 4, prompt_len: int = 8,
        max_new: int = 16, seed: int = 0, capture: bool = False,
        smoke: bool = False, device=None) -> ServeRun:
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.is_encdec:
        raise SystemExit("use examples/ for enc-dec serving demos")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(model_specs(cfg), gen, cfg.dtype, dev)

    server = capture_client = None
    if capture:
        server = StoreServer(device=dev)
        server.create_table(TableSpec("serving", shape=(batch, cfg.vocab),
                                      capacity=16, engine="ring"))
        capture_client = Client(server)
        capture_client.set_model(
            "lm", lambda p, t: lm.forward(p, cfg, t)[0], params)

    batcher = Batcher(max_batch=batch)
    prompts = torch.randint(0, cfg.vocab, (n_requests, prompt_len),
                            generator=torch.Generator().manual_seed(seed + 1))
    for prompt in prompts.tolist():
        batcher.submit(prompt, max_new_tokens=max_new)

    t0 = time.perf_counter()
    completed, steps, tps = serve_loop(
        params, cfg, batcher, t_max=prompt_len + max_new + 8,
        max_steps=5000, capture_client=capture_client)
    wall = time.perf_counter() - t0
    lat = [r.finished_at - r.submitted_at for r in completed
           if r.finished_at is not None]
    print(f"served {len(completed)}/{n_requests} requests in {wall:.2f}s "
          f"({steps} steps, {tps:.1f} tok/s, "
          f"p50 latency {sorted(lat)[len(lat)//2]*1e3:.0f}ms)" if lat else
          f"served {len(completed)} in {wall:.2f}s")
    return ServeRun(completed, steps, tps, wall, server)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--capture", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    run(args.arch, n_requests=args.requests, batch=args.batch,
        prompt_len=args.prompt_len, max_new=args.max_new,
        capture=args.capture, smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
