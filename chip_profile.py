#!/usr/bin/env python3
"""Where the port's detect phase spends its time, on one NVIDIA card.

Run from the repository root: ``python3 chip_profile.py [--trace FILE]``.
It runs ``chip_smoke.py``'s headline config (2.048 M rows, 16 partitions,
per_batch 100) twice to warm up, then traces one more detect phase —
the runner plus the synchronize that ends it — with ``torch.profiler``
(CPU and CUDA activities) and prints one JSON object:

* ``detect_s``: the traced detect phase on the host clock;
* ``kernels``: device kernels launched, and ``kernel_busy_s`` their summed
  device time (kernels on one stream do not overlap);
* ``idle_share``: ``1 - kernel_busy_s / detect_s``;
* ``top_kernels``: the kernels with the most device time, with counts;
* ``top_ops``: the PyTorch operators launched most often.

``--trace FILE`` also writes the Chrome trace. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SMOKE
    from distributed_drift_detection_tpu_torch import api, config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="", help="write the Chrome trace here")
    args = ap.parse_args()

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    dev = torch.device("cuda")
    prep = api.prepare(config.RunConfig(**SMOKE), device=dev)
    batches = api.upload(prep.batches, dev)
    for _ in range(2):
        prep.runner(batches)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prep.runner(batches)
        torch.cuda.synchronize()
        detect_s = time.perf_counter() - t0

    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    kern = [e for e in averages if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kern)
    if not kern:
        print("chip_profile: the trace holds no device kernels", file=sys.stderr)
        return 1
    ops = [e for e in averages if e.device_type != cuda and e.key.startswith("aten::")]
    print(json.dumps({
        "detect_s": detect_s,
        "kernels": sum(e.count for e in kern),
        "kernel_busy_s": busy_us / 1e6,
        "idle_share": 1.0 - busy_us / 1e6 / detect_s,
        "top_kernels": [
            {"name": e.key[:90], "count": e.count, "device_s": e.self_device_time_total / 1e6}
            for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
        ],
        "top_ops": [
            {"op": e.key, "count": e.count}
            for e in sorted(ops, key=lambda e: -e.count)[:15]
        ],
    }))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
