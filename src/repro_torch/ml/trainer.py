"""In-situ trainer (the paper's data-consumer component, §4).

Port of ``src/repro/ml/trainer.py`` — the single-device tiers.  At the
start of each epoch the trainer gathers ``gather`` snapshots from the store
at random, standardises them with per-channel statistics published once as
store metadata, holds one out for validation, and runs Adam on the rest in
mini-batches; MSE loss, lr scaled by the rank count (paper §4).

Two tiers, one numerics (``EPOCH_BUILDERS``):

* ``fused`` — the epoch runs as one read-only capture of the table
  (``Client.capture_epoch``): one store op per epoch.  In the reference
  the whole epoch is one jitted dispatch; here it is a host loop that
  enqueues the epoch's work while holding the table lock, all on one
  stream, so a producer's later in-place put is ordered after the gather.
* ``per_verb`` — one ``sample_batch`` verb, then the same microsteps.  It
  trains on the same data in the same order, and the two tiers give
  bit-identical ``TrainState``\\ s.

Differences from the reference, all deliberate:

* **Draws.**  JAX's threefry cannot be reproduced in torch, so every
  random choice of an epoch is an explicit input (:class:`EpochDraws`:
  the sample draw, the held-out index, the train permutation), and
  ``insitu_train`` takes them as :class:`TrainDraws` (plus the norm-stats
  bootstrap's draw).  By default they come from a ``torch.Generator``
  seeded from ``cfg.seed``, on the trainer's device; the parity tests
  feed draws that reproduce the reference's own ranks instead.
* **Functional epochs.**  An epoch returns a new ``TrainState`` and never
  updates the one it was given, so the off-clock warm-up on an empty
  table (the reference's compile warm-up, here cuBLAS and allocator
  set-up, timed as ``warmup``) leaves the model untouched.
* The multi-device tiers (``mesh``, ``ddp``, ``slab_sharded``,
  ``db_mesh``) and crash recovery (``memckpt``) raise
  ``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, NamedTuple

import torch

from ..core import store as S
from ..core.client import Client
from ..core.telemetry import block_until_ready
from ..device import resolve_device
from ..train import optimizer as opt
from ..tree import tree_map
from . import autoencoder as ae

__all__ = ["TrainState", "TrainerConfig", "EpochResult", "EpochDraws",
           "TrainDraws", "draw_epoch", "default_draws", "init_state",
           "train_state_from_numpy", "value_and_grad", "make_train_step",
           "make_fused_epoch",
           "make_per_verb_epoch", "EPOCH_BUILDERS", "insitu_train"]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


@dataclass(frozen=True)
class TrainerConfig:
    """Consumer-loop configuration (paper §4 values as defaults).

    ``fused`` picks the one-capture epoch (default) over the per-verb
    loop.  ``mesh``, ``ddp``, ``slab_sharded`` and ``db_mesh`` configure
    the reference's multi-device tiers and raise here (``ROADMAP.md`` A5).
    """

    ae: ae.AEConfig
    epochs: int = 50
    gather: int = 6              # tensors gathered per rank per epoch (paper)
    batch_size: int = 4
    lr: float = 1e-4             # paper base lr, scaled by n_ranks
    n_ranks: int = 1
    min_snapshots: int = 1
    wait_timeout_s: float = 60.0
    table: str = "field"
    seed: int = 0
    fused: bool = True           # one-capture epochs via Client.capture_epoch
    mesh: Any = None
    ddp: str = "psum"
    slab_sharded: bool = False
    db_mesh: Any = None

    def __post_init__(self):
        for name, unset in (("mesh", self.mesh is None),
                            ("ddp", self.ddp == "psum"),
                            ("slab_sharded", not self.slab_sharded),
                            ("db_mesh", self.db_mesh is None)):
            if not unset:
                raise NotImplementedError(
                    f"TrainerConfig.{name}: the multi-device trainer tiers "
                    f"are ROADMAP.md A5")

    @property
    def scaled_lr(self) -> float:
        return self.lr * self.n_ranks   # paper's linear scaling rule


@dataclass
class EpochResult:
    epoch: int
    train_loss: float
    val_loss: float
    val_rel_error: float
    watermark: int


class EpochDraws(NamedTuple):
    """One epoch's random choices (the reference splits its epoch key three
    ways for them)."""

    sample: torch.Tensor    # [gather] uniforms in [0, 1) (store.sample)
    val_idx: torch.Tensor   # integer scalar in [0, gather): held-out tensor
    perm: torch.Tensor      # [max(gather - 1, 1)] permutation of the rest


class TrainDraws(NamedTuple):
    """Every draw of one ``insitu_train`` run: the norm-stats bootstrap's
    sample draw, then one :class:`EpochDraws` per epoch."""

    bootstrap: torch.Tensor
    epochs: Iterable[EpochDraws]


def draw_epoch(cfg: TrainerConfig, generator: torch.Generator,
               device) -> EpochDraws:
    """One epoch's draws from ``generator`` (on ``device``)."""
    n_train = max(cfg.gather - 1, 1)
    return EpochDraws(
        sample=torch.rand(cfg.gather, generator=generator, device=device),
        val_idx=torch.randint(cfg.gather, (), generator=generator,
                              device=device),
        perm=torch.randperm(n_train, generator=generator, device=device))


def default_draws(cfg: TrainerConfig, device) -> TrainDraws:
    """The run's draws from a ``torch.Generator`` seeded from ``cfg.seed``
    on ``device``: drawn on the device, read by no host code."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    bootstrap = torch.rand(cfg.gather, generator=gen, device=device)
    return TrainDraws(bootstrap, (draw_epoch(cfg, gen, device)
                                  for _ in range(cfg.epochs)))


def init_state(cfg: TrainerConfig, generator: torch.Generator,
               tx: opt.GradientTransformation, device=None) -> TrainState:
    params = ae.init_autoencoder(cfg.ae, generator, device)
    return TrainState(params=params, opt_state=tx.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=resolve_device(device)))


def train_state_from_numpy(params, mu=None, nu=None, step: int = 0,
                           device=None) -> TrainState:
    """A ``TrainState`` from the reference's params pytree and Adam moments
    converted to numpy (``ae.params_from_numpy`` layout), so a test can
    start both packages from the same mid-training state.  ``mu``/``nu``
    default to zeros; ``step`` is the Adam and train step."""
    dev = resolve_device(device)
    params = ae.params_from_numpy(params, dev)
    zeros = tree_map(torch.zeros_like, params)
    step_t = torch.tensor(step, dtype=torch.int32, device=dev)
    opt_state = opt.AdamState(
        step=step_t.clone(),
        mu=zeros if mu is None else ae.params_from_numpy(mu, dev),
        nu=tree_map(torch.zeros_like, params) if nu is None
        else ae.params_from_numpy(nu, dev))
    return TrainState(params=params, opt_state=opt_state, step=step_t)


def value_and_grad(loss_of: Callable, params):
    """``(loss, grads)`` of ``loss_of(params)`` with the grads in the params'
    tree layout; ``params`` themselves are left untouched."""
    leaves: list[torch.Tensor] = []

    def track(p):
        leaves.append(p.detach().requires_grad_(True))
        return leaves[-1]

    tracked = tree_map(track, params)
    with torch.enable_grad():
        loss = loss_of(tracked)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: TrainerConfig, levels,
                    tx: opt.GradientTransformation) -> Callable:
    """``(state, batch [B, N, C]) -> (state, loss)``: one Adam microstep."""

    def step(state: TrainState, batch: torch.Tensor):
        loss, grads = value_and_grad(
            lambda p: ae.loss_fn(p, cfg.ae, levels, batch), state.params)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            params = opt.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


def _standardize_stats(batch: torch.Tensor):
    """Per-channel mean / population std over [B, N, C] → ([C], [C])."""
    mu = batch.mean(dim=(0, 1))
    sd = batch.std(dim=(0, 1), correction=0) + 1e-6
    return mu, sd


def _prep(cfg: TrainerConfig, vals: torch.Tensor, draws: EpochDraws, mu,
          sd):
    """Standardise a gathered ``[G, C, N]`` batch, hold out
    ``draws.val_idx`` and shuffle the rest → ``(train [G-1, N, C],
    val [1, N, C])``; the per-verb tier's whole data step."""
    dev = vals.device
    data = (vals.transpose(1, 2) - mu) / sd                 # [G, N, C]
    val_idx = draws.val_idx.to(dev, torch.int64).reshape(1)
    val = data.index_select(0, val_idx)
    if cfg.gather > 1:
        tr_idx = (val_idx + 1 + torch.arange(cfg.gather - 1, device=dev)) \
            % cfg.gather
    else:
        tr_idx = torch.zeros(1, dtype=torch.int64, device=dev)
    train = data.index_select(0, tr_idx)
    return train.index_select(0, draws.perm.to(dev, torch.int64)), val


def _epoch_data(cfg: TrainerConfig, spec: S.TableSpec,
                table_state: S.TableState, draws: EpochDraws, mu, sd):
    """The per-epoch data pipeline of the fused epoch: random store gather,
    standardisation, held-out validation tensor, shuffled train set →
    ``(train [G-1, N, C], val [1, N, C], ok)``."""
    vals, _, ok = S.sample(spec, table_state, draws.sample)
    return (*_prep(cfg, vals, draws, mu, sd), ok)


def _windows(cfg: TrainerConfig) -> tuple[int, list[int]]:
    """Mini-batch size and the starts of the equal-size clipped windows
    over the shuffled train set (the last shifted back to full size)."""
    n_train = max(cfg.gather - 1, 1)
    bs = min(cfg.batch_size, n_train)
    n_batches = -(-n_train // bs)
    return bs, [min(i * bs, n_train - bs) for i in range(n_batches)]


def _validate(cfg: TrainerConfig, levels, params, val):
    with torch.no_grad():
        rec = ae.reconstruct(params, cfg.ae, levels, val)
        return torch.mean(torch.square(rec - val)), \
            ae.rel_frobenius(val, rec)


def _warm_draws(cfg: TrainerConfig, device) -> EpochDraws:
    """Fixed draws for the off-clock warm-up (none taken from the run's)."""
    n_train = max(cfg.gather - 1, 1)
    return EpochDraws(torch.zeros(cfg.gather, device=device),
                      torch.zeros((), dtype=torch.int64, device=device),
                      torch.arange(n_train, device=device))


def make_fused_epoch(cfg: TrainerConfig, levels,
                     tx: opt.GradientTransformation, spec: S.TableSpec):
    """The one-capture epoch over a checked-out table state:

        (table_state, train_state, draws, mu, sd)
            -> (train_state, (train_loss, val_loss, val_rel, ok))

    random store gather (``store.sample``), standardisation, held-out
    validation tensor, shuffled mini-batch Adam, validation metrics.  The
    metrics stay on the device; the caller reads them.
    """
    bs, starts = _windows(cfg)
    micro = make_train_step(cfg, levels, tx)

    def epoch(table_state: S.TableState, state: TrainState,
              draws: EpochDraws, mu, sd):
        train, val, ok = _epoch_data(cfg, spec, table_state, draws, mu, sd)
        losses = []
        for s in starts:
            state, loss = micro(state, train[s:s + bs])
            losses.append(loss)
        val_loss, val_rel = _validate(cfg, levels, state.params, val)
        return state, (torch.stack(losses).mean(), val_loss, val_rel, ok)

    return epoch


def make_per_verb_epoch(cfg: TrainerConfig, levels,
                        tx: opt.GradientTransformation, spec: S.TableSpec):
    """The paper-fidelity epoch: :func:`make_fused_epoch`'s math driven
    verb by verb through a live ``Client`` — one ``sample_batch`` (a store
    op, timed as ``retrieve``), then the microsteps (timed as ``train``)
    and validation.  ``epoch(client, state, draws, mu, sd)`` returns the
    same ``(state, metrics)``; ``epoch.warmup(state, mu, sd)`` runs one
    microstep and a validation on zeros, off the store."""
    bs, starts = _windows(cfg)
    micro = make_train_step(cfg, levels, tx)

    def epoch(client: Client, state: TrainState, draws: EpochDraws, mu,
              sd):
        vals, _, ok = client.sample_batch(cfg.table, cfg.gather,
                                          draws.sample)
        train, val = _prep(cfg, vals, draws, mu, sd)
        losses = []
        with client.timers.time("train"):
            for s in starts:
                state, loss = micro(state, train[s:s + bs])
                losses.append(loss)
            block_until_ready(state.params)
        val_loss, val_rel = _validate(cfg, levels, state.params, val)
        return state, (torch.stack(losses).mean(), val_loss, val_rel, ok)

    def warmup(state: TrainState, mu, sd):
        dev = mu.device
        vals = torch.zeros((cfg.gather, *spec.shape), dtype=spec.dtype,
                           device=dev)
        train, val = _prep(cfg, vals, _warm_draws(cfg, dev), mu, sd)
        warm, _ = micro(state, train[starts[0]:starts[0] + bs])
        block_until_ready(_validate(cfg, levels, warm.params, val))

    epoch.warmup = warmup
    return epoch


#: trainer tier → epoch builder (the plan's ``trainer_tier`` picks the key)
EPOCH_BUILDERS: dict[str, Callable] = {
    "fused": make_fused_epoch,
    "per_verb": make_per_verb_epoch,
}


def insitu_train(client: Client, coords: torch.Tensor, cfg: TrainerConfig,
                 stop_event=None,
                 on_epoch: Callable[[EpochResult], None] | None = None,
                 state: TrainState | None = None, tier: str | None = None,
                 memckpt=None, component: str | None = None,
                 on_checkpoint: Callable[[int, TrainState], None]
                 | None = None,
                 draws: TrainDraws | None = None):
    """The consumer loop.  Returns ``(state, [EpochResult...], levels,
    (mu, sd))``.

    Waits (at most ``cfg.wait_timeout_s``) for the first snapshots, then
    publishes per-channel standardisation stats as ``"norm_stats"``
    metadata from one bootstrap gather (unless another trainer already
    did), warms the epoch up off the clock on an empty table, and runs
    ``cfg.epochs`` epochs of ``tier`` (default: ``plan.trainer_tier(cfg)``)
    on the server's device.  ``draws`` defaults to :func:`default_draws`.
    ``on_checkpoint(epoch, state)`` fires at the end of every epoch (the
    hot-swap publication hook); ``component`` names the declared crash
    point each epoch opens with.
    """
    if memckpt is not None:
        raise NotImplementedError(
            "insitu_train(memckpt=...): MemoryCheckpoint recovery is "
            "ROADMAP.md A4")
    if tier is None:
        from ..insitu.plan import trainer_tier
        tier = trainer_tier(cfg)
    if tier not in EPOCH_BUILDERS:
        raise ValueError(f"unknown trainer tier {tier!r} "
                         f"(have {sorted(EPOCH_BUILDERS)})")
    dev = client.server.device
    levels = ae.coords_pyramid(cfg.ae, torch.as_tensor(coords).to(dev))
    tx = opt.adam(cfg.scaled_lr)
    if state is None:
        state = init_state(cfg, torch.Generator().manual_seed(cfg.seed), tx,
                           dev)
    spec = client.server.spec(cfg.table)
    epoch_fn = EPOCH_BUILDERS[tier](cfg, levels, tx, spec)
    fused = tier == "fused"
    if draws is None:
        draws = default_draws(cfg, dev)
    epoch_draws = iter(draws.epochs)
    history: list[EpochResult] = []

    # Paper: "the ML workload must query the database multiple times while
    # waiting for the first training snapshot".
    client.wait_for_data(cfg.table, minimum=cfg.min_snapshots,
                         timeout=cfg.wait_timeout_s)
    mu_sd = client.get_metadata("norm_stats")
    if mu_sd is None:
        first, _, _ok = client.sample_batch(cfg.table, cfg.gather,
                                            draws.bootstrap)
        mu_sd = _standardize_stats(first.transpose(1, 2))
        client.put_metadata("norm_stats", mu_sd)
    mu, sd = (t.to(dev) for t in mu_sd)

    with client.timers.time("warmup"):
        if fused:
            block_until_ready(epoch_fn(S.init_table(spec, dev), state,
                                       _warm_draws(cfg, dev), mu, sd)[1])
        else:
            epoch_fn.warmup(state, mu, sd)

    epoch_timer_start = time.perf_counter()
    for epoch in range(cfg.epochs):
        if stop_event is not None and stop_event.is_set():
            break
        if component is not None:
            client.fault_point(component, epoch)
        ep_draws = next(epoch_draws)
        if fused:
            with client.timers.time("retrieve"):
                prev = state
                state, metrics = client.capture_epoch(
                    cfg.table,
                    lambda txn: epoch_fn(txn.state, prev, ep_draws, mu, sd))
            with client.timers.time("train"):
                block_until_ready(state.params)
        else:
            state, metrics = epoch_fn(client, state, ep_draws, mu, sd)
        train_loss, val_loss, val_rel, _ok = metrics
        res = EpochResult(epoch=epoch, train_loss=float(train_loss),
                          val_loss=float(val_loss),
                          val_rel_error=float(val_rel),
                          watermark=client.watermark(cfg.table))
        history.append(res)
        if on_epoch is not None:
            on_epoch(res)
        if on_checkpoint is not None:
            on_checkpoint(epoch, state)
    client.timers.record("total_training",
                         time.perf_counter() - epoch_timer_start)
    return state, history, levels, (mu, sd)
