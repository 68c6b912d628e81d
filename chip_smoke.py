#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one line (or a few):

1. device — the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build  — compile every kernel from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, in parallel);
3. kernels — each kernel against its plain PyTorch version on the card,
   at the serving path's shapes, with its time, the plain version's, one
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
   thread per component (the default ``run()``), responses checked.

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


def check_gather(dev) -> dict:
    from repro_torch.kernels.store import ops, ref
    gen = torch.Generator().manual_seed(SEED)
    capacity, n = 32, 8
    slab = torch.randn((capacity, 4, 4096), generator=gen).to(dev)
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
            "shape": f"n={n} rows of [4, 4096] f32"}


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

    # 3. kernels vs their plain versions, at the serving path's shapes
    probe = check_probe(dev)
    gather = check_gather(dev)
    blocks = [check_quadconv(dev, MAX_BATCH, 4096, 4, 16),
              check_quadconv(dev, MAX_BATCH, 1024, 16, 16)]
    for row in (probe, gather, *blocks):
        print(f"[kernels] {json.dumps(row)}", flush=True)
    quad = {"name": "quadconv_contract", "route": "cuda",
            "source": "src/repro_torch/kernels/quadconv/csrc/quadconv.cu",
            "replaces": "src/repro/kernels/quadconv/kernel.py:39",
            "max_abs_err": max(b["max_abs_err"] for b in blocks),
            "bound_by": "bytes",
            "timed_by": "+".join(sorted({b["timed_by"] for b in blocks})),
            "shape": "encoder blocks 0 + 1 at B=8 (times summed)"}
    for k in ("ms", "wall_ms", "plain_ms", "plain_wall_ms", "library_ms",
              "bound_ms"):
        quad[k] = sum(b[k] for b in blocks)

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
    rest = t_enc - sum(t_g) - quad["ms"]
    print(f"[breakdown] encode B={MAX_BATCH}: {t_enc:.3f} ms = filter-MLP "
          f"kernel tensor G block0 {t_g[0]:.3f} + block1 {t_g[1]:.3f} + "
          f"quadconv_contract {quad['ms']:.3f} + rest {rest:.3f} ms",
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

    rows = []
    for row in (probe, gather, quad):
        row = dict(row)
        row["launches"] = launches[row["name"]]
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
