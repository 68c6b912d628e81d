"""Three clocks on the same large copies: does ``torch.profiler``'s device
time per kernel agree with CUDA events?

For each workload it prints one JSON line with

* ``profiler_ms``: the device time of every kernel the ``iters`` calls
  launched under ``torch.profiler``, over ``iters`` (``chip_smoke.py``'s
  ``device_ms``), with the number of kernel records the profiler kept and
  the smallest, median and largest single record;
* ``batch_event_ms``: one pair of CUDA events around ``iters`` calls, over
  ``iters`` (``chip_smoke.py``'s ``time_ms``: launch gaps included);
* ``launch_event_ms``: a pair of CUDA events around each call, averaged
  (the device time of one call and its two event records);
* ``bound_ms``: the bytes the call must move over 3.35e12 B/s.

The workloads: the store's gather kernel at the co-located shard shape
(16 rows of [2, 2048, 4096] fp32) and at the reproducer's (24 rows of
16 MB from 48), and ``Tensor.copy_`` of the same 1.07 GB as a control.

Run on the card from the repository root: ``python3 tools/profiler_check.py``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

PEAK_BYTES_PER_S = 3.35e12


def batch_event_ms(fn, iters: int) -> float:
    for _ in range(3):
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


def launch_event_ms(fn, iters: int) -> float:
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    fn()
    torch.cuda.synchronize()
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.fmean(s.elapsed_time(e) for s, e in pairs)


def profiler_ms(fn, iters: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    records = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    return {"ms": total / iters / 1e3, "records": len(records),
            "min_ms": min(records) / 1e3 if records else None,
            "median_ms": statistics.median(records) / 1e3 if records
            else None,
            "max_ms": max(records) / 1e3 if records else None}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.store import ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shard = torch.randn((16, 2, 2048, 4096), generator=gen, device=dev)
    shard_slots = torch.randperm(16, generator=gen, device=dev,
                                 dtype=torch.int32)
    ring = torch.randn((48, 4096, 1024), generator=gen, device=dev)
    ring_slots = torch.randperm(48, generator=gen, device=dev,
                                dtype=torch.int32)[:24]
    dst = torch.empty_like(shard)
    work = {
        "gather shard [2, 2048, 4096] x16": (
            lambda: ops.gather_rows(shard, shard_slots),
            2 * shard.numel() * 4),
        "gather reproducer 16 MB x24": (
            lambda: ops.gather_rows(ring, ring_slots),
            2 * 24 * ring[0].numel() * 4),
        "copy_ 1.07 GB": (lambda: dst.copy_(shard), 2 * shard.numel() * 4),
    }
    for name, (fn, nbytes) in work.items():
        line = {"work": name, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
        for iters in (5, 50, 200):
            line[f"profiler_{iters}"] = profiler_ms(fn, iters)
        line["batch_event_ms"] = batch_event_ms(fn, 200)
        line["launch_event_ms"] = launch_event_ms(fn, 200)
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
