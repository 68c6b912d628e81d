#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one line (or a few):

1. device — the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build  — compile every kernel from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, in parallel);
3. kernels — each kernel against its plain PyTorch version on the card,
   at its main path's shapes, with its time, the plain version's, one
   library call's, and the least time the card could take (its bound);
4. serving — the port's serving plane end to end: 4 clients × 8 requests
   of flat-plate snapshots [4, 4096] through ``continuous_batch`` (max
   batch 8), served by the QuadConv encoder at the paper config's widths
   (channels 4, internal 16, latent 100, 2 blocks, pool 4, filter MLP
   64 × 5) with random seeded weights; the plan's predictions must equal
   ``stats()``, every kernel must have launched, and every response must
   match the plain-version encoder run on the card; then where a drained
   batch's device time goes (CUDA events), and the same session once more
   under ``torch.profiler`` (the device's busy share, each kernel's device
   time per launch);
5. three-step — the same requests through the ``three_step`` tier;
6. threaded — the continuous-batching session once more with one host
   thread per component (the default ``run()``), responses checked;
7. grad — one training microstep of the autoencoder at the same widths
   and 2,048 points: the loss and every parameter gradient with the
   contraction kernel's forward against the plain einsum's (and, as a
   control that must fail the same limit, the einsum's with TF32
   matmuls), and where the microstep's device time goes;
8. train — the paper's in-situ workflow: a flat-plate producer (40
   steps, every 2nd emitted, ring of 24), the fused trainer (8 epochs,
   gather 6, batch 4, lr 1e-3) and 5 in-situ inference calls, first
   sequential then threaded; one line per epoch (losses, relative
   Frobenius error, device ms), the plan's dispatches against
   ``stats()``, the launch counts, the peak memory, and every inference
   output against the plain encoder with the trained weights;
9. launch — ``repro_torch.launch.insitu.run(points="medium", epochs=4,
   sim_steps=40)``, the launcher a user calls.

Kernel, plain and library times in the kernels line are device times per
call (``torch.profiler``: the summed device time of every kernel and copy
the call launched); ``wall_ms`` beside them is the CUDA-event time per
call over back-to-back calls, which a launch-bound kernel spends mostly
in host enqueue.

Then one JSON line with every kernel's numbers, the ``nvidia-smi`` line,
and as the last line ``{"ok": true, "device": {...}}``.  Any failure
raises and the script exits non-zero; without a CUDA device it exits 1
before doing anything.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32, outside the tensor cores
SEED = 0
CLIENTS, REQUESTS, MAX_BATCH = 4, 8, 8
# the training slice (paper §4, reference launcher's "medium" grid)
SIM_STEPS, EMIT_EVERY, RING, EPOCHS, GATHER, BATCH, N_INF = \
    40, 2, 24, 8, 6, 4, 5


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float | None:
    """Device time of one call of ``fn``: the device time of every kernel
    and copy its ``iters`` calls launched, under ``torch.profiler``, over
    ``iters``; None when the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / iters / 1e3 if total else None


def timed(fn, iters: int) -> dict:
    """``ms`` (device time per call; the CUDA-event time where the
    profiler saw nothing), ``wall_ms`` (CUDA events) and which was used."""
    wall = time_ms(fn, iters)
    dev = device_ms(fn, iters)
    return {"ms": wall if dev is None else dev, "wall_ms": wall,
            "timed_by": "cuda_events" if dev is None else "torch.profiler"}


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def profile(run) -> str:
    """Run ``run()`` under ``torch.profiler``: the device's busy share of
    the wall clock and each port kernel's device time per launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "the profiler saw no device activity: not measured"
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    per_launch = {}
    for name, pattern in (("probe_slots", "probe_kernel"),
                          ("sample_slots", "sample_kernel"),
                          ("gather_rows", "gather_kernel"),
                          ("quadconv_contract", "quadconv_contract_kernel")):
        hits = [e for e in kernels if pattern in e.key]
        if hits:
            per_launch[name] = round(
                sum(e.self_device_time_total for e in hits)
                / sum(e.count for e in hits) / 1e3, 5)
    return (f"wall_s={wall:.4f} device_busy_s={busy:.4f} "
            f"idle_share={1 - busy / wall:.3f} "
            f"device_ms_per_launch={per_launch}")


def check_probe(dev) -> dict:
    from repro_torch.kernels.store import ops, ref
    gen = torch.Generator().manual_seed(SEED)
    capacity, n = 32, 8
    keys = torch.randint(0, 2**31, (capacity,), generator=gen,
                         dtype=torch.int64)
    keys[5] = keys[17] = keys[29]          # duplicates: lowest live slot wins
    keys[3] = ref.EMPTY_KEY                # a never-written slot
    version = torch.randint(1, 100, (capacity,), generator=gen,
                            dtype=torch.int32)
    version[5] = 0                         # dead slot holding a live key
    query = torch.tensor([keys[29], keys[0], keys[31], ref.EMPTY_KEY, 12345,
                          keys[3], keys[10], keys[17]], dtype=torch.int64)
    keys, version, query = keys.to(dev), version.to(dev), query.to(dev)
    idx, found = ops.probe_slots(keys, version, query)
    idx_r, found_r = ref.probe_slots_ref(keys, version, query)
    err = int((idx - idx_r).abs().max())
    if err or not torch.equal(found, found_r):
        raise AssertionError(f"probe kernel disagrees: {idx} vs {idx_r}")
    kernel = timed(lambda: ops.probe_slots(keys, version, query), 200)
    plain = timed(lambda: ref.probe_slots_ref(keys, version, query), 200)
    b, by = bound(capacity * (8 + 4) + n * (8 + 4))
    return {"name": "probe_slots", "route": "cuda",
            "source": "src/repro_torch/kernels/store/csrc/store.cu",
            "replaces": "src/repro/kernels/store/kernel.py:48",
            "max_abs_err": err, **kernel, "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": None,
            "bound_ms": b, "bound_by": by,
            "shape": f"capacity={capacity} n={n}"}


def check_sample(dev) -> dict:
    """The sample kernel against its plain version, exactly: at the
    trainer's shapes (C = 24, n = 6) and at C = 4096, n = 256, with dead
    slots, an empty table, and ranks below 0 and past the live count."""
    from repro_torch.kernels.store import ops, ref
    gen = torch.Generator().manual_seed(SEED)
    cases = []
    for capacity, n, live in ((RING, GATHER, 0.75), (4096, 256, 0.5),
                              (RING, GATHER, 0.0)):
        version = torch.randint(1, 100, (capacity,), generator=gen,
                                dtype=torch.int32)
        version[torch.rand(capacity, generator=gen) >= live] = 0
        nvalid = int((version > 0).sum())
        ranks = torch.randint(0, max(nvalid, 1), (n,), generator=gen,
                              dtype=torch.int32)
        ranks[:3] = torch.tensor([-1, nvalid, nvalid + 5])
        cases.append((version.to(dev), ranks.to(dev)))
    for version, ranks in cases:
        got = ops.sample_slots(version, ranks)
        want = ref.sample_slots_ref(version, ranks)
        if not torch.equal(got, want):
            raise AssertionError(f"sample kernel disagrees at C="
                                 f"{version.numel()}: {got} vs {want}")
    version, ranks = cases[0]
    kernel = timed(lambda: ops.sample_slots(version, ranks), 200)
    plain = timed(lambda: ref.sample_slots_ref(version, ranks), 200)
    b, by = bound((version.numel() + 2 * ranks.numel()) * 4)
    return {"name": "sample_slots", "route": "cuda",
            "source": "src/repro_torch/kernels/store/csrc/store.cu",
            "replaces": "src/repro/kernels/store/kernel.py:99",
            "max_abs_err": 0, **kernel, "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": None,
            "bound_ms": b, "bound_by": by,
            "shape": f"capacity={version.numel()} n={ranks.numel()} "
                     "(also checked: C=4096 n=256, an empty table)"}


def check_gather(dev, capacity: int, n: int, points: int) -> dict:
    from repro_torch.kernels.store import ops, ref
    gen = torch.Generator().manual_seed(SEED)
    slab = torch.randn((capacity, 4, points), generator=gen).to(dev)
    slots = torch.randint(0, capacity, (n,), generator=gen,
                          dtype=torch.int32).to(dev)
    out = ops.gather_rows(slab, slots)
    out_r = ref.gather_rows_ref(slab, slots)
    err = float((out - out_r).abs().max())
    if err:
        raise AssertionError(f"gather kernel disagrees (max err {err})")
    kernel = timed(lambda: ops.gather_rows(slab, slots), 200)
    plain = timed(lambda: ref.gather_rows_ref(slab, slots), 200)
    slots64 = slots.long()
    library = timed(lambda: torch.index_select(slab, 0, slots64), 200)
    b, by = bound(2 * n * slab[0].numel() * 4 + n * 4)
    return {"name": "gather_rows", "route": "cuda",
            "source": "src/repro_torch/kernels/store/csrc/store.cu",
            "replaces": "src/repro/kernels/store/kernel.py:142",
            "max_abs_err": err, **kernel, "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": library["ms"],
            "bound_ms": b, "bound_by": by,
            "shape": f"capacity={capacity} n={n} rows of [4, {points}] f32"}


def check_quadconv(dev, B: int, I: int, C: int, O: int) -> dict:
    from repro_torch.kernels.quadconv import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f = torch.randn((B, I, C), generator=gen, device=dev)
    w = torch.rand((I,), generator=gen, device=dev) / I
    g = torch.randn((I, I, O, C), generator=gen, device=dev)
    out = ops.quadconv_contract(f, w, g)
    out_r = ref.quadconv_contract_ref(f, w, g)
    err = float((out - out_r).abs().max())
    # fp32 sums of I*C = 16384 terms in two orders: relative 1e-4 of the
    # output's magnitude
    tol = 1e-4 * float(out_r.abs().max())
    if not err <= tol:
        raise AssertionError(f"quadconv kernel disagrees at I={I}: max err "
                             f"{err} > {tol}")
    kernel = timed(lambda: ops.quadconv_contract(f, w, g), 20)
    plain = timed(lambda: ref.quadconv_contract_ref(f, w, g), 10)
    library = timed(
        lambda: torch.einsum("i,jioc,bic->bjo", w, g, f), 10)
    b, by = bound(4 * (g.numel() + f.numel() + w.numel() + B * I * O),
                  2.0 * B * I * I * O * C)
    del g
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "tol": tol, **kernel,
            "plain_ms": plain["ms"], "plain_wall_ms": plain["wall_ms"],
            "library_ms": library["ms"], "bound_ms": b, "bound_by": by,
            "shape": f"B={B} I=J={I} C={C} O={O}"}


def leaves(tree) -> list:
    """Tensor leaves of nested dicts/lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def grad_errors(got: list, want: list) -> tuple[float, float, bool]:
    """The largest gradient difference over the microstep's largest
    gradient entry and over the leaf's own largest entry, and whether
    every leaf is within the ``[grad]`` limit (1e-4 and 1e-3 of those)."""
    gmax = max(float(b.abs().max()) for b in want)
    worst_global = worst_own = 0.0
    within = True
    for a, b in zip(got, want):
        own = float(b.abs().max())
        err = float((a - b).abs().max())
        within &= (err <= 1e-4 * gmax and err <= 1e-3 * own
                   and bool(torch.isfinite(a).all()))
        worst_global = max(worst_global, err / gmax)
        worst_own = max(worst_own, err / own if own else 0.0)
    return worst_global, worst_own, within


def check_grad(cfg, levels, params, batch) -> dict:
    """One microstep's loss and parameter gradients with the contraction
    kernel's forward against the plain einsum's.

    Every leaf must agree within 1e-4 of the largest gradient entry of
    the microstep, and within 1e-3 of its own largest entry; the loss
    within 1e-4 relative.  (A bias leaf's gradient is a sum of B·N terms
    of both signs, so its own maximum can be far below the terms it
    sums, and fp32 summation order alone moves it by about 1e-4 of that
    maximum at 2,048 points; ``PERF.md`` has the measurement.)  As a
    control, the einsum microstep with TF32 matmuls (10-bit mantissas)
    is held to the same limit and must fail it.
    """
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml import trainer as tr
    out = {}
    for mode, tf32 in ((None, False), ("ref", False), ("ref", True)):
        mcfg = replace(cfg, mode=mode)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = tr.value_and_grad(
            lambda p: ae.loss_fn(p, mcfg, levels, batch), params)
        torch.cuda.synchronize()
        out[mode, tf32] = (float(loss), leaves(grads),
                           torch.cuda.max_memory_allocated() / 1e9)
    torch.backends.cuda.matmul.allow_tf32 = False
    (lk, gk, peak_k), (lr, gr, peak_r), (lt, gt, _) = out.values()
    worst_global, worst_own, within = grad_errors(gk, gr)
    if not within:
        raise AssertionError(f"a gradient leaf differs by {worst_global} "
                             f"of the microstep's largest gradient and "
                             f"{worst_own} of its own")
    if not abs(lk - lr) <= 1e-4 * abs(lr):
        raise AssertionError(f"loss {lk} (kernel) vs {lr} (einsum)")
    tf32_global, tf32_own, tf32_within = grad_errors(gt, gr)
    if tf32_within:
        raise AssertionError("the TF32 control passed the [grad] limit: "
                             "the limit no longer tells fp32 from TF32")
    return {"loss_kernel": lk, "loss_einsum": lr, "leaves": len(gk),
            "max_err_over_grad_max": worst_global,
            "max_err_over_leaf_max": worst_own,
            "grad_max": max(float(b.abs().max()) for b in gr),
            "tf32_loss_rel": abs(lt - lr) / abs(lr),
            "tf32_max_err_over_grad_max": tf32_global,
            "tf32_max_err_over_leaf_max": tf32_own,
            "peak_gb_kernel": peak_k, "peak_gb_einsum": peak_r}


def microstep_breakdown(cfg, levels, params, batch) -> dict:
    """Device time of one training microstep by part (CUDA events): the
    filter MLPs building the four kernel tensors G, the four contraction
    forwards, the rest of the forward, the backward, the Adam update; and
    of the backward, the four contractions' own (einsum) backward with
    the device memory it takes beyond its inputs."""
    from repro_torch.kernels.quadconv import ops as qops
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml import trainer as tr
    from repro_torch.ml.quadconv import QuadConv
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_map
    blocks = []
    for b in range(cfg.blocks):
        blocks.append((cfg.channels if b == 0 else cfg.internal,
                       params["enc"][b], levels[b]))
    for b in range(cfg.blocks):
        blocks.append((cfg.internal, params["dec"][b],
                       levels[cfg.blocks - b - 1]))
    convs = [(QuadConv(c_in=c, c_out=cfg.internal, mlp_width=cfg.mlp_width,
                       mlp_depth=cfg.mlp_depth, support=cfg.support), p, lv)
             for c, p, lv in blocks]
    t_g = time_ms(lambda: [conv.kernel_tensor(p, lv, lv)
                           for conv, p, lv in convs], 3, warmup=1)
    gs = [conv.kernel_tensor(p, lv, lv).requires_grad_(True)
          for conv, p, lv in convs]
    fs = [torch.randn((batch.shape[0], lv.shape[0], conv.c_in),
                      device=batch.device, requires_grad=True)
          for conv, _, lv in convs]
    ws = [p["quad_w"].detach().requires_grad_(True) for _, p, _ in convs]
    t_c = time_ms(lambda: [qops.quadconv_contract(f, w, g)
                           for f, w, g in zip(fs, ws, gs)], 5)
    # the contraction's backward alone: the reference's einsums
    outs = [qops.quadconv_contract(f, w, g) for f, w, g in zip(fs, ws, gs)]
    cts = [torch.randn_like(o) for o in outs]

    def contraction_backward():
        for o, ct, f, w, g in zip(outs, cts, fs, ws, gs):
            torch.autograd.grad(o, (f, w, g), ct, retain_graph=True)

    t_cb = time_ms(contraction_backward, 3, warmup=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    contraction_backward()
    torch.cuda.synchronize()
    cb_extra = (torch.cuda.max_memory_allocated() - base) / 1e9
    del gs, fs, ws, outs, cts

    def forward():
        tracked = tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
        with torch.enable_grad():
            return ae.loss_fn(tracked, cfg, levels, batch)

    def step():
        return tr.value_and_grad(
            lambda p: ae.loss_fn(p, cfg, levels, batch), params)

    t_f = time_ms(forward, 3, warmup=1)
    t_vg = time_ms(step, 3, warmup=1)
    _, grads = step()
    tx = opt.adam(1e-3)
    st = tx.init(params)
    t_o = time_ms(lambda: opt.apply_updates(
        params, tx.update(grads, st, params)[0]), 10)
    return {"total_ms": t_vg + t_o, "g_build_ms": t_g,
            "contraction_fwd_ms": t_c, "rest_fwd_ms": t_f - t_g - t_c,
            "backward_ms": t_vg - t_f, "optimizer_ms": t_o,
            "of_which_contraction_bwd_ms": t_cb,
            "contraction_bwd_extra_gb": cb_extra}


def train_session(dev, cfg, fcfg, sequential: bool, counters,
                  label: str | None = None) -> dict:
    """The paper's workflow as one session: flat-plate producer → fused
    trainer → in-situ inference, checked end to end."""
    from repro_torch.core import TableSpec
    from repro_torch.core import store as S
    from repro_torch.insitu import (InferenceConsumer, InSituSession,
                                    Producer, TrainerConsumer)
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml import trainer as tr
    from repro_torch.sim import flatplate as fp
    gen = torch.Generator().manual_seed(SEED)
    modes = fp.draw_modes(fcfg, gen, dev)
    inf_modes = fp.draw_modes(fcfg, gen, dev)
    coords = fp.grid_coords(fcfg, dev)
    tcfg = tr.TrainerConfig(ae=cfg, epochs=EPOCHS, gather=GATHER,
                            batch_size=BATCH, lr=1e-3, seed=SEED)
    draws = tr.default_draws(tcfg, dev)
    starts, ends, history, inputs = [], [], [], {}

    def timed_epochs():
        for d in draws.epochs:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            yield d

    def on_epoch(r):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        history.append(r)

    def step_fn(carry, rank, t):
        return carry, S.make_key(rank, t), fp.snapshot(fcfg, modes, t,
                                                       coords)

    def feed(client, step):
        mu, sd = client.get_metadata("norm_stats")
        x = (fp.snapshot(fcfg, inf_modes, SIM_STEPS + step, coords).T
             - mu) / sd
        inputs[step] = x
        return x

    sess = InSituSession(
        tables=[TableSpec("field", shape=(4, fcfg.n_points),
                          capacity=RING)],
        components=[
            Producer(step_fn, table="field", steps=SIM_STEPS,
                     carry=torch.zeros((), device=dev),
                     emit_every=EMIT_EVERY),
            TrainerConsumer(tcfg, coords, model_key="encoder",
                            on_epoch=on_epoch,
                            draws=tr.TrainDraws(draws.bootstrap,
                                                timed_epochs())),
            InferenceConsumer("encoder", feed, steps=N_INF)],
        device=dev)
    plan = sess.plan()
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sess.run(plan=plan, sequential=sequential, max_wall_s=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in counters}
    peak = torch.cuda.max_memory_allocated() / 1e9
    mode = label or ("sequential" if sequential else "threaded")
    if not res.ok:
        raise AssertionError({n: c.error for n, c in
                              res.run.components.items() if c.error})
    stats = res.server.stats()
    for r, a, b in zip(history, starts, ends):
        print(f"[train {mode}] epoch {r.epoch} train_loss={r.train_loss:.6f} "
              f"val_loss={r.val_loss:.6f} rel_frobenius="
              f"{r.val_rel_error:.6f} ms={a.elapsed_time(b):.3f} "
              f"watermark={r.watermark}", flush=True)
    losses = [x for r in history
              for x in (r.train_loss, r.val_loss, r.val_rel_error)]
    if len(history) != EPOCHS or not all(map(math.isfinite, losses)) \
            or not history[-1].train_loss < history[0].train_loss:
        raise AssertionError(f"{mode}: losses not finite and falling: "
                             f"{history}")
    if stats["op_count"] != plan.store_dispatches:
        raise AssertionError(f"{mode}: plan {plan.explain()} != stats "
                             f"{stats}")
    microsteps = EPOCHS * -(-(GATHER - 1) // BATCH)
    need = {"sample_slots": EPOCHS + 1, "gather_rows": EPOCHS + 1,
            "quadconv_contract": 4 * microsteps}
    for sym, least in need.items():
        if launches[sym] < least:
            raise AssertionError(f"{mode}: {sym} launched {launches[sym]} "
                                 f"times, expected >= {least}")
    trainer = res.output("trainer")
    inf = res.output("inference")
    ref_cfg = replace(cfg, mode="ref")
    err, zmax = 0.0, 0.0
    for step, z in enumerate(inf.outputs):
        want = ae.encode(trainer.state.params, ref_cfg, trainer.levels,
                         inputs[step][None])[0]
        if z.shape != (cfg.latent,) or not bool(torch.isfinite(z).all()):
            raise AssertionError(f"inference output {step}: {z.shape}")
        err = max(err, float((z - want).abs().max()))
        zmax = max(zmax, float(want.abs().max()))
    tol = 1e-4 * (1.0 + zmax)
    if inf.steps != N_INF or not err <= tol:
        raise AssertionError(f"{mode}: {inf.steps} inference outputs, max "
                             f"err vs plain encoder {err} > {tol}")
    walls = {n: round(c.wall_s, 4) for n, c in res.run.components.items()}
    verbs = {n: round(t["mean_s"] * 1e3, 3)
             for n, t in res.run.timers.summary().items()}
    print(f"[train {mode}] predicted_dispatches={plan.store_dispatches} "
          f"op_count={stats['op_count']} "
          f"per_component={ {c.name: c.store_dispatches for c in plan.components} } "
          f"launches={launches} peak_mem_gb={peak:.2f} wall_s={wall:.4f} "
          f"component_wall_s={walls} verb_mean_ms={verbs} "
          f"inference_max_err_vs_plain={err:.3g} (tol {tol:.3g})",
          flush=True)
    return {"launches": launches, "peak_gb": peak, "wall_s": wall,
            "op_count": stats["op_count"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import TableSpec
    from repro_torch.insitu import (InSituSession, ServingClients,
                                    ServingConsumer)
    from repro_torch.kernels import _build
    from repro_torch.kernels.quadconv import ops as qops
    from repro_torch.kernels.store import ops as sops
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml.quadconv import QuadConv
    from repro_torch.sim import flatplate as fp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {lib.name}: {line.strip()}")

    # 3. kernels vs their plain versions, at their main paths' shapes:
    # the serving plane's (B = 8, 4,096 points) and the trainer's (B = 4,
    # 2,048 points; a ring of 24, 6 rows gathered per epoch)
    probe = check_probe(dev)
    sample = check_sample(dev)
    gather_serving = check_gather(dev, CLIENTS * REQUESTS, MAX_BATCH, 4096)
    gather = check_gather(dev, RING, GATHER, 2048)
    serve_blocks = [check_quadconv(dev, MAX_BATCH, 4096, 4, 16),
                    check_quadconv(dev, MAX_BATCH, 1024, 16, 16)]
    enc0, mid, dec1 = (check_quadconv(dev, BATCH, 2048, 4, 16),
                       check_quadconv(dev, BATCH, 512, 16, 16),
                       check_quadconv(dev, BATCH, 2048, 16, 16))
    train_blocks = [enc0, mid, mid, dec1]   # encoder 0, 1; decoder 0, 1
    for row in (probe, sample, gather_serving, gather, *serve_blocks,
                enc0, mid, dec1):
        print(f"[kernels] {json.dumps(row)}", flush=True)
    timing_keys = ("ms", "wall_ms", "plain_ms", "plain_wall_ms",
                   "library_ms", "bound_ms")
    quad = {"name": "quadconv_contract", "route": "cuda",
            "source": "src/repro_torch/kernels/quadconv/csrc/quadconv.cu",
            "replaces": "src/repro/kernels/quadconv/kernel.py:39",
            "max_abs_err": max(b["max_abs_err"] for b in train_blocks),
            "bound_by": "bytes",
            "timed_by": "+".join(sorted({b["timed_by"]
                                         for b in train_blocks})),
            "shape": "one training forward at B=4: encoder 0 (I=J=2048, "
                     "C=4), encoder 1 and decoder 0 (I=J=512, C=16), "
                     "decoder 1 (I=J=2048, C=16); times summed",
            **{k: sum(b[k] for b in train_blocks) for k in timing_keys},
            "serving": {"shape": "encoder blocks 0 + 1 at B=8, 4,096 "
                                 "points (times summed)",
                        **{k: sum(b[k] for b in serve_blocks)
                           for k in timing_keys}}}
    gather["serving"] = {k: gather_serving[k] for k in
                         ("shape", *timing_keys)}

    # 4. serving: continuous batching through the kernels
    fcfg = fp.FlatPlateConfig(nx=16, ny=16, nz=16)
    cfg = ae.AEConfig(n_points=fcfg.n_points, channels=4, internal=16,
                      latent=100, blocks=2, pool=4, mlp_width=64,
                      mlp_depth=5)
    gen = torch.Generator().manual_seed(SEED)
    params = ae.init_autoencoder(cfg, gen, dev)
    modes = fp.draw_modes(fcfg, gen, dev)
    coords = fp.grid_coords(fcfg, dev)
    levels = ae.coords_pyramid(cfg, coords)
    snaps = {(c, s): fp.snapshot(fcfg, modes, 100 * c + s, coords)
             for c in range(CLIENTS) for s in range(REQUESTS)}

    def model(p, xs):
        return ae.encode(p, cfg, levels, xs.transpose(1, 2))

    def preload(server):
        server.set_model("encoder", model, params)

    def session(tier):
        tables = [TableSpec("sreq", shape=(4, fcfg.n_points),
                            capacity=CLIENTS * REQUESTS),
                  TableSpec("sres", shape=(cfg.latent,),
                            capacity=CLIENTS * REQUESTS)]
        return InSituSession(tables=tables, device=dev, components=[
            ServingClients(lambda c, s: snaps[(c, s)], table="sreq",
                           clients=CLIENTS, requests=REQUESTS,
                           collect=False, name="writers"),
            ServingConsumer("encoder", table="sreq", results="sres",
                            clients=CLIENTS, requests=REQUESTS,
                            max_batch=MAX_BATCH, tier=tier),
            ServingClients(lambda c, s: snaps[(c, s)], table="sreq",
                           clients=CLIENTS, requests=REQUESTS,
                           submit=False, name="readers")])

    xs = torch.stack([snaps[k] for k in sorted(snaps)])
    model(params, xs[:MAX_BATCH])             # warm-up (cuBLAS, allocator)
    z_ref = ae.encode(params, replace(cfg, mode="ref"), levels,
                      xs.transpose(1, 2))
    torch.cuda.synchronize()
    tol = 1e-4 * (1.0 + float(z_ref.abs().max()))
    kernels = [sops.PROBE, sops.GATHER, qops.QUADCONV]

    def drive(tier, sequential=True):
        sess = session(tier)
        plan = sess.plan()
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = sess.run(plan=plan, sequential=sequential, preload=preload,
                       max_wall_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels}
        if not res.ok:
            raise AssertionError({n: c.error
                                  for n, c in res.run.components.items()})
        stats = res.server.stats()
        out = res.output("serving")
        predicted = dict(plan.component("serving").dispatches).get("serve", 0)
        # threads drain whatever has arrived, so only a sequential run
        # drains the predicted batches; every other dispatch is exact
        if (sequential and out.batches != predicted) \
                or stats["op_count"] != (plan.store_dispatches - predicted
                                         + out.batches) \
                or stats["model_swaps"] != plan.model_swaps:
            raise AssertionError(f"plan {plan.explain()} != stats {stats}, "
                                 f"batches {out.batches}")
        resp = res.output("readers").responses
        err = 0.0
        for i, key in enumerate(sorted(snaps)):
            z = resp[key]
            if z.shape != (cfg.latent,) or not bool(torch.isfinite(z).all()):
                raise AssertionError(f"response {key}: {z.shape}")
            err = max(err, float((z - z_ref[i]).abs().max()))
        if not err <= tol:
            raise AssertionError(f"{tier}: responses differ from the plain "
                                 f"encoder by {err} > {tol}")
        walls = {n: round(c.wall_s, 4) for n, c in res.run.components.items()}
        verbs = {n: round(t["mean_s"] * 1e3, 3)
                 for n, t in res.run.timers.summary().items()}
        mode = tier if sequential else f"{tier} threaded"
        print(f"[{mode}] requests={len(resp)} batches={out.batches} "
              f"swaps={stats['model_swaps']} op_count={stats['op_count']} "
              f"predicted={plan.store_dispatches} launches={launches} "
              f"max_err_vs_plain={err:.3g} (tol {tol:.3g}) wall_s={wall:.4f} "
              f"requests_per_s={len(resp) / wall:.2f} component_wall_s="
              f"{walls} verb_mean_ms={verbs} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
        return resp, launches

    batched, launches = drive("continuous_batch")
    n_batches = -(-CLIENTS * REQUESTS // MAX_BATCH)
    need = {"probe_slots": n_batches, "gather_rows": n_batches,
            "quadconv_contract": 2 * n_batches}
    for sym, least in need.items():
        if launches[sym] < least:
            raise AssertionError(f"{sym} launched {launches[sym]} times on "
                                 f"the serving path, expected >= {least}")

    # where a drained batch's time goes (device time, CUDA events)
    x8 = xs[:MAX_BATCH]
    t_enc = time_ms(lambda: model(params, x8), 5)
    t_g = []
    for b, c_in in enumerate((cfg.channels, cfg.internal)):
        conv = QuadConv(c_in=c_in, c_out=cfg.internal,
                        mlp_width=cfg.mlp_width, mlp_depth=cfg.mlp_depth,
                        support=cfg.support)
        t_g.append(time_ms(lambda: conv.kernel_tensor(
            params["enc"][b], levels[b], levels[b]), 5))
    t_contract = quad["serving"]["ms"]
    rest = t_enc - sum(t_g) - t_contract
    print(f"[breakdown] encode B={MAX_BATCH}: {t_enc:.3f} ms = filter-MLP "
          f"kernel tensor G block0 {t_g[0]:.3f} + block1 {t_g[1]:.3f} + "
          f"quadconv_contract {t_contract:.3f} + rest {rest:.3f} ms",
          flush=True)

    print("[profile] continuous_batch session: " + profile(
        lambda: session("continuous_batch").run(
            sequential=True, preload=preload, max_wall_s=600)), flush=True)

    # 5. three-step: the same requests one at a time
    single, _ = drive("three_step")
    diff = max(float((batched[k] - single[k]).abs().max()) for k in batched)
    if not diff <= tol:
        raise AssertionError(f"three-step differs from batched by {diff}")
    print(f"[three_step] max |three_step - continuous_batch| = {diff:.3g}")

    # 6. threaded: one host thread per component, as run() defaults to
    drive("continuous_batch", sequential=False)

    # 7. grad: one training microstep at the paper's widths, 2,048 points
    tfcfg = fp.FlatPlateConfig(nx=16, ny=16, nz=8)
    tcfg = replace(cfg, n_points=tfcfg.n_points)
    tgen = torch.Generator().manual_seed(SEED + 1)
    tparams = ae.init_autoencoder(tcfg, tgen, dev)
    tmodes = fp.draw_modes(tfcfg, tgen, dev)
    tcoords = fp.grid_coords(tfcfg, dev)
    tlevels = ae.coords_pyramid(tcfg, tcoords)
    batch = torch.stack([fp.snapshot(tfcfg, tmodes, t, tcoords).T
                         for t in range(BATCH)])
    batch = (batch - batch.mean(dim=(0, 1))) / batch.std(dim=(0, 1))
    grad = check_grad(tcfg, tlevels, tparams, batch)
    print(f"[grad] B={BATCH} N={tcfg.n_points} {json.dumps(grad)}",
          flush=True)
    bd = microstep_breakdown(tcfg, tlevels, tparams, batch)
    print("[breakdown] training microstep: " + " ".join(
        f"{k}={v:.3f}" for k, v in bd.items()), flush=True)
    del tparams, batch
    torch.cuda.empty_cache()

    # 8. train: the paper's in-situ workflow, sequential then threaded
    counters = [sops.PROBE, sops.SAMPLE, sops.GATHER, qops.QUADCONV]
    trained = train_session(dev, tcfg, tfcfg, True, counters)
    train_session(dev, tcfg, tfcfg, False, counters)
    print("[profile] training session (sequential): " + profile(
        lambda: train_session(dev, tcfg, tfcfg, True, counters,
                              label="profiled")), flush=True)

    # 9. launch: the launcher a user calls, at its own defaults
    from repro_torch.launch import insitu as launcher
    t0 = time.perf_counter()
    res = launcher.run(points="medium", epochs=4, sim_steps=40, device=dev)
    torch.cuda.synchronize()
    if res.server.stats()["op_count"] != res.plan.store_dispatches:
        raise AssertionError(f"launcher: {res.server.stats()} vs "
                             f"{res.plan.explain()}")
    print(f"[launch] run(points='medium', epochs=4, sim_steps=40) ok in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    serving_launches = launches
    rows = []
    for row, path in ((probe, "serving"), (sample, "training"),
                      (gather, "training"), (quad, "training")):
        row = dict(row)
        name = row["name"]
        row["path"] = path
        row["launches"] = (serving_launches if path == "serving"
                           else trained["launches"])[name]
        row["launches_by_path"] = {
            "serving": serving_launches.get(name, 0),
            "training": trained["launches"][name]}
        if row["launches"] < 1:
            raise AssertionError(f"{name} never launched on its path")
        row["kernel_ms"] = row["ms"]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
