"""Simulation reproducer (paper §3): the Fortran send/retrieve driver.

Port of ``src/repro/sim/reproducer.py``.  The paper's scaling study runs
a Fortran "reproducer" that gives each rank a client, loops over time
steps (sleeping to emulate PDE integration), sends its contribution under
a rank/step key and retrieves it back; for the inference study it also
evaluates a stored model every iteration.  ``run_transfer`` is the
send/retrieve loop, ``run_inference`` the send → run_model → retrieve
loop; both return the per-component :class:`~repro_torch.core.Timers`.

Differences from the reference, all deliberate:

* The payload is an input: ``run_transfer(..., data=...)``.  JAX's
  threefry draw cannot be reproduced in torch, so without ``data`` the
  port draws its own from a seeded ``torch.Generator`` on the server's
  device; the parity tests pass the reference's draw in through numpy.
* The registry contract: the port's ``run_model`` calls the model on a
  batch of one element (``StoreServer.set_model``).  In the inference loop
  one stored element is a whole image batch, so a model that takes a batch
  is registered through :func:`fold_registry_axis`, which folds the
  registry's axis into the image batch and back.
* The output spec comes from one untimed registry call, where the
  reference asks ``jax.eval_shape``.
* ``on_read(step, values, founds)``, when given, sees each step's values
  read back (all ranks, ``[n_ranks, elems]``) outside the timers, so a
  caller can check them; the reference has no such hook.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..core.client import Client
from ..core.server import StoreServer
from ..core.store import TableSpec, make_key
from ..core.telemetry import Timers, block_until_ready

__all__ = ["ReproducerConfig", "run_transfer", "run_inference",
           "fold_registry_axis"]


@dataclass(frozen=True)
class ReproducerConfig:
    n_ranks: int = 24            # simulation ranks (paper: 24/node)
    bytes_per_rank: int = 256 * 1024   # paper default message size
    iterations: int = 40         # paper: 40 timed iterations
    warmup: int = 2              # paper: 2 discarded warmup iterations
    compute_s: float = 0.0       # sleep emulating PDE integration
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def elems_per_rank(self) -> int:
        return self.bytes_per_rank // self.torch_dtype.itemsize

    def table_spec(self, capacity: int | None = None) -> TableSpec:
        # One slab row per rank, ring-buffered over a window of steps.
        return TableSpec(name="repro", shape=(self.elems_per_rank,),
                         dtype=self.torch_dtype,
                         capacity=capacity or max(2 * self.n_ranks, 8),
                         engine="ring")


def _payload(cfg: ReproducerConfig, device, seed: int = 0) -> torch.Tensor:
    """All ranks' contributions for one step: [n_ranks, elems], normal
    draws from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((cfg.n_ranks, cfg.elems_per_rank), generator=gen,
                       dtype=cfg.torch_dtype, device=device)


def run_transfer(cfg: ReproducerConfig, server: StoreServer,
                 vectorized: bool = True, data=None,
                 on_read: Callable | None = None) -> Timers:
    """The paper's data-transfer loop: sleep, send, retrieve, repeat.

    ``vectorized=True`` sends all ranks' tensors in one ``put_many`` and
    reads them back in one ``get_many`` (the probe and gather kernels):
    two store ops a step.  ``vectorized=False`` issues one put and one get
    per rank (per-client requests, the Polaris picture): ``2 · n_ranks``
    ops a step.  ``data`` ([n_ranks, elems]; default: a seeded draw) is
    every step's payload.  The first ``cfg.warmup`` iterations are left off
    the returned timers.
    """
    if "repro" not in server.tables():
        server.create_table(cfg.table_spec())
    client = Client(server)
    dev = server.device
    data = _payload(cfg, dev) if data is None \
        else torch.as_tensor(data, dtype=cfg.torch_dtype, device=dev)
    block_until_ready(data)
    ranks = torch.arange(cfg.n_ranks, device=dev)
    timers = client.timers

    for it in range(cfg.warmup + cfg.iterations):
        if it == cfg.warmup:
            timers = Timers()
            client.timers = timers
        if cfg.compute_s:
            time.sleep(cfg.compute_s)
        step = it
        if vectorized:
            client.send_batch("repro", step, data)
            keys = make_key(ranks, step)
            with timers.time("retrieve") as box:
                vals, founds = server.get_many("repro", keys)
                box[0] = vals
        else:
            for rank in range(cfg.n_ranks):
                rc = Client(server, rank=rank, timers=timers)
                rc.send_step("repro", step, data[rank])
            got = []
            for rank in range(cfg.n_ranks):
                rc = Client(server, rank=rank, timers=timers)
                got.append(rc.retrieve_step("repro", rank, step))
            if on_read is not None:
                vals = torch.stack([v for v, _ in got])
                founds = torch.stack([f for _, f in got])
        if on_read is not None:
            on_read(step, vals, founds)
    return timers


def fold_registry_axis(apply_fn: Callable) -> Callable:
    """Register a model whose stored element is a whole batch: the
    registry's leading axis folds into the batch and back,
    ``[k, n, *x] → apply_fn(params, [k·n, *x]) → [k, n, *y]``, so
    ``run_model`` and ``Client.infer`` return ``apply_fn``'s ``[n, *y]``
    for a stored ``[n, *x]``."""
    def fn(params, xs):
        k, n = xs.shape[:2]
        ys = apply_fn(params, xs.reshape(k * n, *xs.shape[2:]))
        return ys.reshape(k, n, *ys.shape[1:])

    fn.__name__ = f"fold_registry_axis({getattr(apply_fn, '__name__', '')})"
    return fn


def run_inference(cfg: ReproducerConfig, server: StoreServer,
                  model_key: str, batch, fused: bool = False) -> Timers:
    """The paper's inference loop: send → run_model → retrieve each step.

    ``batch`` is the per-step input (ResNet-50 images [n, 3, 224, 224]); the
    model must already be registered on the server, taking ``batch`` as one
    element (see :func:`fold_registry_axis`).  ``fused=True`` takes the
    one-call registry path (``Client.infer``) instead of the three-step
    protocol.  The first ``cfg.warmup`` iterations are left off the
    returned timers.
    """
    client = Client(server)
    batch = torch.as_tensor(batch, device=server.device)
    if "infer_in" not in server.tables():
        # the output spec, from one untimed registry call
        out = block_until_ready(server.run_model(model_key, batch))
        server.create_table(TableSpec("infer_in", shape=tuple(batch.shape),
                                      dtype=batch.dtype, capacity=2,
                                      engine="hash"))
        server.create_table(TableSpec("infer_out", shape=tuple(out.shape),
                                      dtype=out.dtype, capacity=2,
                                      engine="hash"))
    block_until_ready(batch)
    timers = client.timers

    for it in range(cfg.warmup + cfg.iterations):
        if it == cfg.warmup:
            timers = Timers()
            client.timers = timers
        if cfg.compute_s:
            time.sleep(cfg.compute_s)
        if fused:
            block_until_ready(client.infer(model_key, batch))
            continue
        client.put_tensor("x", batch, table="infer_in")
        client.run_model(model_key, inputs=["x"], outputs=["y"],
                         table="infer_in", out_table="infer_out")
        y, _found = client.get_tensor("y", table="infer_out")
        block_until_ready(y)
    return timers
