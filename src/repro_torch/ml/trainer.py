"""In-situ trainer (the paper's data-consumer component, §4).

Port of ``src/repro/ml/trainer.py``.  At the start of each epoch the
trainer gathers ``gather`` snapshots from the store at random, standardises
them with per-channel statistics published once as store metadata, holds
one out for validation, and runs Adam on the rest in mini-batches; MSE
loss, lr scaled by the rank count (paper §4).

Five tiers (``EPOCH_BUILDERS``), all on the same data stream:

* ``fused`` — the epoch runs as one read-only capture of the table
  (``Client.capture_epoch``): one store op per epoch.  In the reference
  the whole epoch is one jitted dispatch; here it is a host loop that
  enqueues the epoch's work while holding the table lock, all on one
  stream, so a producer's later in-place put is ordered after the gather.
* ``per_verb`` — one ``sample_batch`` verb, then the same microsteps.  It
  trains on the same data in the same order, and the two tiers give
  bit-identical ``TrainState``\\ s.
* ``sharded_fused`` and ``slab_sharded`` — the fused epoch with DDP over
  ``cfg.mesh`` (:func:`make_sharded_fused_epoch`): each rank of each
  microstep takes its ``batch_size / D`` slice, the gradients and loss are
  summed with ``collectives.psum`` and divided by D, and one Adam update
  runs per distinct device of the mesh.  ``cfg.ddp="int8"`` sends the
  gradients over the int8 wire instead (``parallel.compress``), with
  ``cfg.ddp_error_feedback`` a per-rank residual carried from microstep
  to microstep and reset at each epoch.  ``sharded_fused`` enters with the
  table whole on every device (a slab-sharded table is all-gathered);
  ``slab_sharded`` gathers each rank's own rows from the sharded slab
  (``store.sample_sharded_impl``) and equals ``sharded_fused`` bit for bit.
* ``slab_sharded_clustered`` — the table lives slot-partitioned on a
  ``Clustered`` deployment's dedicated db mesh (``cfg.db_mesh``), the
  DDP epoch runs on ``cfg.mesh`` (the client ranks): each epoch is ONE
  ``Client.sample_staged`` (the shard-local gather on the db mesh, one
  staged hop back), then the same DDP body on the staged batch
  (:func:`make_clustered_sharded_epoch`).  With as many db ranks as
  trainer ranks it equals ``slab_sharded`` bit for bit.

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
* **Crash recovery.**  The reference checkpoints its rng key; the port
  checkpoints its draw stream's cursor: ``memckpt`` parks ``{"state",
  "draws", "history"}``, where ``draws`` is the run's epoch-draw
  iterator, positioned at the next epoch, so a resumed run takes the
  same draws from the same epoch.
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
from ..parallel import collectives as C
from ..parallel import compress as CP
from ..parallel.sharding import slab_sharding
from ..train import optimizer as opt
from ..tree import tree_map, value_and_grad
from . import autoencoder as ae

__all__ = ["TrainState", "TrainerConfig", "EpochResult", "EpochDraws",
           "TrainDraws", "draw_epoch", "default_draws", "init_state",
           "train_state_from_numpy", "value_and_grad", "make_train_step",
           "make_fused_epoch", "make_per_verb_epoch",
           "make_sharded_fused_epoch", "make_clustered_sharded_epoch",
           "EPOCH_BUILDERS", "CLIENT_DRIVEN_TIERS", "insitu_train"]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


@dataclass(frozen=True)
class TrainerConfig:
    """Consumer-loop configuration (paper §4 values as defaults).

    ``fused`` picks the one-capture epoch (default) over the per-verb
    loop.  ``mesh`` (a ``parallel.sharding.Mesh``) trains data-parallel
    over its ``mesh_axis``, its gradients summed exactly (``ddp="psum"``)
    or over the int8 wire (``ddp="int8"``; ``ddp_error_feedback`` carries
    each rank's quantization residual through the epoch's microsteps);
    ``slab_sharded`` has the table enter the epoch split over that mesh.
    ``db_mesh`` / ``db_axis`` are the slab-sharded *clustered* data plane
    (tier ``slab_sharded_clustered``): the table lives slot-partitioned on that
    dedicated mesh (a ``Clustered`` deployment's db ranks; a session wires
    them from the deployment) while the DDP epoch runs on ``mesh``;
    ``db_mesh`` needs ``slab_sharded=True``.
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
    mesh: Any = None             # parallel.sharding.Mesh -> DDP tiers
    mesh_axis: str = "data"      # mesh axis the batch shards over
    ddp: str = "psum"            # "psum" (exact) | "int8" (compressed wire)
    ddp_error_feedback: bool = True   # int8: residual rides the microsteps
    slab_sharded: bool = False   # table enters the epoch pre-sharded
    db_mesh: Any = None          # clustered: the store's dedicated mesh
    db_axis: str | None = None   # clustered: slot-partition axis on db_mesh

    def __post_init__(self):
        if self.ddp not in ("psum", "int8"):
            raise ValueError(f"unknown ddp mode {self.ddp!r}")
        if self.mesh is not None and not self.fused:
            raise ValueError("mesh-sharded training requires fused=True")
        if self.slab_sharded and self.mesh is None:
            raise ValueError("slab_sharded needs a mesh (the slab shards "
                             "over cfg.mesh_axis)")
        if self.db_mesh is not None and not self.slab_sharded:
            raise ValueError("db_mesh is the slab-sharded clustered data "
                             "plane; it needs slab_sharded=True")
        if self.db_mesh is not None and self.db_axis is not None \
                and self.db_axis not in self.db_mesh.axis_names:
            raise ValueError(f"db_axis {self.db_axis!r} is not an axis of "
                             f"the db mesh {self.db_mesh.axis_names}")
        if self.mesh is not None and self.mesh_axis != self.mesh.axis:
            # the port's mesh is 1-D: its one axis is the only one to shard
            raise ValueError(f"mesh_axis {self.mesh_axis!r} is not the "
                             f"mesh's axis {self.mesh.axis!r}")

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


def _ddp_epoch(cfg: TrainerConfig, levels, tx: opt.GradientTransformation):
    """The DDP epoch body over ``cfg.mesh`` on a gathered batch:
    ``run(vals {device: [G, *shape]}, ok, state, draws, mu, sd) ->
    (state, metrics)``.  The data step runs once per distinct device of
    the mesh (replicated compute); each microstep's ranks take their
    ``batch_size / D`` slices of the mini-batch, the loss is ``psum``-ed
    and divided by D, the gradients are too (``ddp="psum"``) or cross the
    int8 wire (``ddp="int8"``: ``compress.compressed_psum_mean``, or its
    ``_ef`` form with one residual a rank, zeros at the epoch's start, the
    reference's scan carry), and each distinct device applies one Adam
    update to its replica of the state (so ranks sharing a card share
    one).  Validation runs on rank 0's device, which holds the returned
    state and metrics."""
    mesh = cfg.mesh
    axis, ndev = mesh.axis, mesh.size
    bs, starts = _windows(cfg)
    if bs % ndev:
        raise ValueError(
            f"batch_size {bs} must divide by mesh axis {axis!r} size {ndev}")
    bl = bs // ndev
    home = mesh.devices[0]
    devices = mesh.distinct_devices
    lv = {d: tree_map(lambda t: t.to(d), levels) for d in devices}
    int8 = cfg.ddp == "int8"
    feedback = int8 and cfg.ddp_error_feedback

    def grads_of(params, dev, batch):
        return value_and_grad(
            lambda p: ae.loss_fn(p, cfg.ae, lv[dev], batch), params)

    def run(vals: dict, ok, state: TrainState, draws: EpochDraws, mu, sd):
        data = {d: _prep(cfg, v, draws, mu.to(d), sd.to(d))
                for d, v in vals.items()}
        states = {d: tree_map(lambda t: t.to(d), state) for d in devices}
        resid = [tree_map(torch.zeros_like, states[d].params)
                 for d in mesh.devices] if feedback else None
        losses = []
        for s in starts:
            per_rank = [grads_of(states[d].params, d,
                                 data[d][0][s + r * bl:s + (r + 1) * bl])
                        for r, d in enumerate(mesh.devices)]
            loss = C.psum([lo for lo, _ in per_rank], mesh)
            local = [g for _, g in per_rank]
            if feedback:
                grads, resid = CP.compressed_psum_mean_ef(local, resid, mesh)
            elif int8:
                grads = CP.compressed_psum_mean(local, mesh)
            else:
                grads = C.psum(local, mesh)
            with torch.no_grad():
                for d in devices:
                    g = grads[d] if int8 \
                        else tree_map(lambda x: x / ndev, grads[d])
                    updates, opt_state = tx.update(g, states[d].opt_state,
                                                   states[d].params)
                    states[d] = TrainState(
                        opt.apply_updates(states[d].params, updates),
                        opt_state, states[d].step + 1)
            losses.append(loss[home] / ndev)
        val_loss, val_rel = _validate(cfg, lv[home], states[home].params,
                                      data[home][1])
        return states[home], (torch.stack(losses).mean(), val_loss, val_rel,
                              ok)

    return run


def make_sharded_fused_epoch(cfg: TrainerConfig, levels,
                             tx: opt.GradientTransformation,
                             spec: S.TableSpec):
    """The fused epoch with DDP over ``cfg.mesh``'s ``cfg.mesh_axis`` (D
    ranks), the reference's one ``shard_map`` as a loop over the ranks
    (:func:`_ddp_epoch`).

    Same signature and draws as :func:`make_fused_epoch`, so the data
    stream is the fused tier's.  The gather runs once per distinct device
    of the mesh.  ``cfg.slab_sharded`` picks the table's entry: split
    (the slab-sharded gather, ``store.sample_sharded_impl``) or whole on
    every device — a slab-sharded table is then ``all_gather``-ed on
    entry.
    """
    mesh = cfg.mesh
    if mesh is None:
        raise ValueError("make_sharded_fused_epoch needs cfg.mesh")
    run = _ddp_epoch(cfg, levels, tx)
    if cfg.slab_sharded and spec.capacity % mesh.size:
        raise ValueError(
            f"slab-sharded entry needs capacity {spec.capacity} "
            f"divisible by mesh axis {mesh.axis!r} size {mesh.size}")

    def epoch(table_state: S.TableState, state: TrainState,
              draws: EpochDraws, mu, sd):
        if cfg.slab_sharded:
            slab = table_state.slab
            if not isinstance(slab, S.ShardedSlab) \
                    or slab.placement.mesh != mesh:
                raise ValueError("slab_sharded: the table is not "
                                 "slab-sharded over cfg.mesh")
            vals, _, ok = S.sample_sharded_impl(spec, table_state,
                                                draws.sample)
        else:
            vals, ok = _replicated_sample(spec, table_state, draws.sample,
                                          mesh)
        return run(vals, ok, state, draws, mu, sd)

    return epoch


def make_clustered_sharded_epoch(cfg: TrainerConfig, levels,
                                 tx: opt.GradientTransformation,
                                 spec: S.TableSpec):
    """The slab-sharded *clustered* tier: the table lives slot-partitioned
    on ``cfg.db_mesh`` (a ``Clustered(slab_axis=...)`` deployment's db
    ranks), the DDP epoch runs on ``cfg.mesh`` (the client ranks).  Each
    epoch is:

    1. ONE ``Client.sample_staged``: slot selection, the shard-local
       gather (``gather_sharded`` once per db shard) and the batch's
       ``psum`` on the db mesh (``store.make_clustered_gather``), then
       ONE counted staged hop of the batch onto the clients;
    2. the DDP body of :func:`make_sharded_fused_epoch` on it
       (:func:`_ddp_epoch`), the batch copied to each distinct device of
       ``cfg.mesh``.

    Client-driven, like :func:`make_per_verb_epoch`: ``epoch(client,
    state, draws, mu, sd)``.  The draws are the other tiers', so the
    training data is too.  ``epoch.warmup(state, mu, sd)`` runs the DDP
    body once on zeros, off the store; ``epoch.train_fn(vals, ok, state,
    draws, mu, sd)`` is step 2 alone (``plan(hlo=True)`` counts its
    collectives)."""
    mesh = cfg.mesh
    if mesh is None:
        raise ValueError("make_clustered_sharded_epoch needs cfg.mesh")
    run = _ddp_epoch(cfg, levels, tx)
    devices = mesh.distinct_devices

    def train_fn(vals: torch.Tensor, ok, state: TrainState,
                 draws: EpochDraws, mu, sd):
        return run({d: vals.to(d) for d in devices}, ok, state, draws, mu,
                   sd)

    def epoch(client: Client, state: TrainState, draws: EpochDraws, mu,
              sd):
        vals, ok = client.sample_staged(cfg.table, cfg.gather, draws.sample)
        with client.timers.time("train"):
            state, metrics = train_fn(vals, ok, state, draws, mu, sd)
            block_until_ready(state.params)
        return state, metrics

    def warmup(state: TrainState, mu, sd):
        dev = mesh.devices[0]
        vals = torch.zeros((cfg.gather, *spec.shape), dtype=spec.dtype,
                           device=dev)
        block_until_ready(train_fn(vals, torch.ones((), dtype=torch.bool,
                                                    device=dev), state,
                                   _warm_draws(cfg, dev), mu, sd)[1])

    epoch.warmup = warmup
    epoch.train_fn = train_fn
    return epoch


def _replicated_sample(spec: S.TableSpec, table_state: S.TableState,
                       draw: torch.Tensor, mesh):
    """``store.sample`` on a whole copy of the table on every distinct
    device of ``mesh`` → ``({device: values}, ok)``.  A sharded table, by
    slot or by element, is assembled first (``store.whole_slab``: the
    reference's replicated entry)."""
    full = S.whole_slab(table_state.slab)
    whole = {d: full.to(d) for d in mesh.distinct_devices}
    out = {d: S.sample(spec, table_state._replace(
        slab=w, keys=table_state.keys.to(d),
        version=table_state.version.to(d)), draw)
        for d, w in whole.items()}
    return {d: v for d, (v, _, _) in out.items()}, out[mesh.devices[0]][2]


#: trainer tier → epoch builder (the plan's ``trainer_tier`` picks the
#: key); the two mesh tiers share a builder, which reads the entry from
#: ``cfg.slab_sharded`` (the tier rules keep the two consistent)
EPOCH_BUILDERS: dict[str, Callable] = {
    "fused": make_fused_epoch,
    "sharded_fused": make_sharded_fused_epoch,
    "slab_sharded": make_sharded_fused_epoch,
    "slab_sharded_clustered": make_clustered_sharded_epoch,
    "per_verb": make_per_verb_epoch,
}

#: tiers whose epoch is driven through a live ``Client`` (store verbs)
#: instead of a capture of the checked-out table state
CLIENT_DRIVEN_TIERS = ("per_verb", "slab_sharded_clustered")


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
    did; the check holds the table's lock, so concurrent trainers
    bootstrap once), warms the epoch up off the clock on an empty table,
    and runs ``cfg.epochs`` epochs of ``tier`` (default:
    ``plan.trainer_tier(cfg)``) on the server's device (the mesh tiers: on
    ``cfg.mesh``, whose rank 0 should be that device).  ``draws`` defaults to :func:`default_draws`.
    ``on_checkpoint(epoch, state)`` fires at the end of every epoch (the
    hot-swap publication hook); ``component`` names the declared crash
    point each epoch opens with.

    Fault tolerance: ``memckpt`` (a ``train.checkpoint.MemoryCheckpoint``)
    parks ``{"state", "draws", "history"}`` in the server's
    metadata after the norm-stats bootstrap and after every epoch.  A
    crashed trainer re-entering this function resumes at the first
    unfinished epoch with the same state and the draw iterator where it
    stopped (the crash point opens an epoch, before its draws are taken),
    so its final state is bit-identical to an uncrashed run's.  The
    resumed run skips the wait, the bootstrap and the warm-up, and the
    checkpoints are host metadata: no store op is added.
    """
    if tier is None:
        from ..insitu.plan import trainer_tier
        tier = trainer_tier(cfg)
    if tier not in EPOCH_BUILDERS:
        raise ValueError(f"unknown trainer tier {tier!r} "
                         f"(have {sorted(EPOCH_BUILDERS)})")
    # the clustered tier trains on its own (client) mesh, the others on
    # the server's device
    dev = cfg.mesh.devices[0] if tier == "slab_sharded_clustered" \
        else client.server.device
    levels = ae.coords_pyramid(cfg.ae, torch.as_tensor(coords).to(dev))
    tx = opt.adam(cfg.scaled_lr)
    resumed = memckpt.restore() if memckpt is not None else None
    if state is None and resumed is None:
        state = init_state(cfg, torch.Generator().manual_seed(cfg.seed), tx,
                           dev)
    spec = client.server.spec(cfg.table)
    epoch_fn = EPOCH_BUILDERS[tier](cfg, levels, tx, spec)
    fused = tier not in CLIENT_DRIVEN_TIERS
    history: list[EpochResult] = []
    start_epoch = 0

    if resumed is not None:
        # crash recovery: the first unfinished epoch, the same draws;
        # the norm stats were published before the first checkpoint
        saved_epoch, payload = resumed
        state, epoch_draws = payload["state"], payload["draws"]
        history = list(payload["history"])
        start_epoch = saved_epoch + 1
        mu, sd = (t.to(dev) for t in client.get_metadata("norm_stats"))
    else:
        if draws is None:
            draws = default_draws(cfg, dev)
        epoch_draws = iter(draws.epochs)
        # Paper: "the ML workload must query the database multiple times
        # while waiting for the first training snapshot".
        client.wait_for_data(cfg.table, minimum=cfg.min_snapshots,
                             timeout=cfg.wait_timeout_s)
        # the check and the publication under the table's lock: trainers
        # starting together (multi-consumer replicas on threads) bootstrap
        # once, as the plan predicts
        with client.server.table_lock(cfg.table):
            mu_sd = client.get_metadata("norm_stats")
            if mu_sd is None:
                first, _, _ok = client.sample_batch(cfg.table, cfg.gather,
                                                    draws.bootstrap)
                mu_sd = _standardize_stats(first.transpose(1, 2))
                client.put_metadata("norm_stats", mu_sd)
        mu, sd = (t.to(dev) for t in mu_sd)

        with client.timers.time("warmup"):
            if fused:
                # the slab-sharded tier warms up on a table placed like
                # its own
                placement = slab_sharding(spec, cfg.mesh) \
                    if tier == "slab_sharded" else None
                table = S.init_table(spec, placement, device=dev)
                block_until_ready(epoch_fn(table, state,
                                           _warm_draws(cfg, dev), mu, sd)[1])
            else:
                epoch_fn.warmup(state, mu, sd)
        if memckpt is not None:
            # the anchor: a crash at epoch 0 resumes here, not at the
            # bootstrap (which would cost another sample op)
            memckpt.save(-1, {"state": state, "draws": epoch_draws,
                              "history": []})

    epoch_timer_start = time.perf_counter()
    for epoch in range(start_epoch, cfg.epochs):
        if stop_event is not None and stop_event.is_set():
            break
        if component is not None:
            # before the draws are taken: a restarted epoch takes them
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
        if memckpt is not None:
            memckpt.save(epoch, {"state": state, "draws": epoch_draws,
                                 "history": list(history)})
        if on_checkpoint is not None:
            on_checkpoint(epoch, state)
    client.timers.record("total_training",
                         time.perf_counter() - epoch_timer_start)
    return state, history, levels, (mu, sd)
