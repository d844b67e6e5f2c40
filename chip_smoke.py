#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and nvcc, and exits non-zero (printing no result)
without them. Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build both hand-written kernels from ``csrc/`` with nvcc (in parallel);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes — the DDM window statistic (K1) bit for bit at
   [16, 128·100] (fresh and carried states, all-padding rows, the
   DDM_ROBUST noise floor), the centroid predict + error indicator (K2)
   with equal predictions and errors at 16 × 12,800 rows, F = 21, C = 40 —
   and time kernel and plain version;
4. drive the main path, ``run(cfg, device="cuda")`` at bench.py's headline
   geometry (2.048 M rows, 16 partitions, per_batch 100) on the synthetic
   twin of outdoorStream: 624 detections, flags equal field by field to the
   same config run through the port on the CPU, and both kernels launched
   (their launch counters are reset just before the run and read just
   after). Final Time is the median of three warm runs.

The line before the last is a JSON object listing each kernel's launches,
error, times and bound; the last line is the device JSON.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SMOKE = dict(
    dataset="synth:prototypes,seed=0,concepts=40,rows_per_concept=100,features=21",
    mult_data=512, partitions=16, per_batch=100, results_csv="",
)
EXPECTED_DETECTIONS = 624  # 16 partitions x 39 planted boundaries
EXPECTED_MEAN_DELAY = 788.63  # rows, the JAX package's run of SMOKE
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean device time of ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ddm_inputs(rng, p, w, b):
    """Bernoulli error indicators with per-partition rate jumps; ragged
    padding, and partition 1 all padding."""
    n = w * b
    flip = rng.integers(0, n, p)[:, None]
    rate = np.where(np.arange(n)[None] < flip, rng.uniform(0, 0.05, (p, 1)),
                    rng.uniform(0.2, 0.9, (p, 1)))
    errs = (rng.random((p, n)) < rate).astype(np.float32).reshape(p, w, b)
    valid = rng.random((p, w, b)) < 0.98
    valid[1] = False
    valid[3, w // 2:] = False
    return errs, valid


def check_k1(torch, ddm, params_mod, p, w, b, dev):
    """K1 against its plain version, bit for bit; returns its kernel row."""
    rng = np.random.default_rng(1)
    cases = {
        "classic": params_mod.DDMParams(),
        "robust": params_mod.DDM_ROBUST,
        "warmup": params_mod.DDMParams(min_num_instances=500),
    }
    timed = None
    for name, prm in cases.items():  # times the classic case
        e0, v0 = (torch.from_numpy(a).to(dev) for a in ddm_inputs(rng, p, 1, 300))
        e1, v1 = (torch.from_numpy(a).to(dev) for a in ddm_inputs(rng, p, w, b))
        # a reachable carried state: the plain version over an earlier window
        fresh = ddm.ddm_init((p,), dev)
        carried, _ = ddm.ddm_window_reference(fresh, e0, v0, prm)
        if name == "warmup":
            check(bool((torch.isinf(carried.ps_min) & torch.isfinite(carried.p_min)).any()),
                  "K1 inputs miss a carried inf state with a finite payload")
        for state in (fresh, carried):
            got = ddm.ddm_window(state, e1, v1, prm)
            want = ddm.ddm_window_reference(state, e1, v1, prm)
            torch.cuda.synchronize()
            for g, r in zip(got[0] + got[1], want[0] + want[1]):
                check(torch.equal(g.view(torch.int32), r.view(torch.int32)),
                      f"K1 differs from its plain version ({name})")
        if timed is None:
            timed = (carried, e1, v1, prm)
    state, e1, v1, prm = timed
    ms = time_ms(lambda: ddm.ddm_window(state, e1, v1, prm))
    plain_ms = time_ms(lambda: ddm.ddm_window_reference(state, e1, v1, prm))
    n = p * w * b
    # each input read once (errs f32, live u8, 5 state leaves), each output
    # written once ([P, W] i32 twice, 5 state leaves); ~14 f32 operations a
    # element (2 divisions, sqrt, 2 FMAs, adds, compares)
    b_ms, by = bound(n * 5 + p * 5 * 4 * 2 + p * w * 8, n * 14)
    print(f"K1 ddm_window [{p}, {w}x{b}]: bitwise equal; {ms:.4f} ms kernel, "
          f"{plain_ms:.4f} ms plain, bound {b_ms:.5f} ms ({by})")
    return dict(
        name="ddm_window", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/ddm_window.cu",
        replaces="distributed_drift_detection_tpu/ops/ddm.py:277",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
        library_ms=None,
    )


def check_k2(torch, classifiers, stream, p, w, b, dev):
    """K2 against its plain version: equal preds and errs; its kernel row."""
    rng = np.random.default_rng(2)
    T = torch.from_numpy(stream.base_X).to(dev)
    Ty = torch.from_numpy(stream.base_y).to(dev)
    c, f = stream.num_classes, stream.num_features
    # centroids near the class means, a quarter of the classes absent per
    # partition, and partition 0 with every class absent (all -inf rows)
    means = np.stack([stream.base_X[stream.base_y == k].mean(0) for k in range(c)])
    cent = (means[None] + 0.05 * rng.normal(size=(p, c, f))).astype(np.float32)
    bias = (-0.5 * (cent.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    bias[rng.random((p, c)) < 0.25] = -np.inf
    bias[0] = -np.inf
    idx = rng.integers(0, len(stream.base_y), (p, w * b)).astype(np.int16)
    args = [torch.from_numpy(a).to(dev) for a in (cent, bias)] + [T, Ty]
    idx_t = torch.from_numpy(idx).to(dev)
    err, pred = classifiers.centroid_predict_err(*args, idx_t, return_pred=True)
    rerr, rpred = classifiers.centroid_predict_err_reference(*args, idx_t)
    torch.cuda.synchronize()
    check(torch.equal(pred, rpred), "K2 predictions differ from its plain version")
    check(torch.equal(err, rerr), "K2 errors differ from its plain version")
    check(bool((err > 0).any()) and bool((err == 0).any()), "K2 inputs give one error value only")
    max_err = float((err - rerr).abs().max())
    ms = time_ms(lambda: classifiers.centroid_predict_err(*args, idx_t))
    plain_ms = time_ms(lambda: classifiers.centroid_predict_err_reference(*args, idx_t))
    rows = p * w * b
    # idx i16 + err f32 per row, the row table and labels, centroids + bias;
    # 2·F·C operations a row for the dot products
    nbytes = rows * 6 + T.numel() * 4 + Ty.numel() * 4 + cent.nbytes + bias.nbytes
    b_ms, by = bound(nbytes, rows * 2 * f * c)
    print(f"K2 centroid_predict_err [{p}, {w * b}] F={f} C={c}: preds and errs "
          f"equal; {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
          f"{b_ms:.5f} ms ({by})")
    return dict(
        name="centroid_predict_err", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/centroid_predict_err.cu",
        replaces="distributed_drift_detection_tpu/models/classifiers.py:100",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=by, library_ms=None,
    )


def main(device: str = "cuda") -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    from distributed_drift_detection_tpu_torch import api, config
    from distributed_drift_detection_tpu_torch.kernels import _build
    from distributed_drift_detection_tpu_torch.models import classifiers
    from distributed_drift_detection_tpu_torch.ops import ddm

    dev = torch.device(device)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f" (wall {time.perf_counter() - t0:.1f} s, nvcc -gencode "
          "arch=compute_90a,code=sm_90a)")

    # 3. each kernel against its plain version at the main path's shapes
    cfg = config.RunConfig(**SMOKE)
    prep = api.prepare(cfg, device=dev)
    w, r, p, b = (prep.config.window, prep.config.window_rotations,
                  prep.config.partitions, prep.config.per_batch)
    print(f"main path: {prep.stream.num_rows} rows, W={w} R={r}, packed idx "
          f"{tuple(prep.batches.idx.shape)} {prep.batches.idx.dtype}, perm "
          f"{prep.batches.perm.dtype}, row table {prep.stream.base_X.shape}")
    check((w, r) == (128, 4), f"auto W x R resolved to {w} x {r}, not 128 x 4")
    rows = [check_k1(torch, ddm, config, p, w, b, dev),
            check_k2(torch, classifiers, prep.stream, p, w, b, dev)]

    # 4. the main path, counted
    t0 = time.perf_counter()
    ref = api.run(cfg, device="cpu")
    print(f"port on the CPU: {ref.metrics.num_detections} detections in "
          f"{time.perf_counter() - t0:.1f} s")
    ddm.ddm_window.launches = 0
    classifiers.centroid_predict_err.launches = 0
    res = api.run(cfg, device=dev)
    launches = {"ddm_window": ddm.ddm_window.launches,
                "centroid_predict_err": classifiers.centroid_predict_err.launches}
    m = res.metrics
    print(f"port on the card: {m.num_detections} detections, mean delay "
          f"{m.mean_delay_rows:.4f} rows, launches {launches}")
    check(m.num_detections == EXPECTED_DETECTIONS,
          f"{m.num_detections} detections, expected {EXPECTED_DETECTIONS}")
    check(abs(m.mean_delay_rows - EXPECTED_MEAN_DELAY) < 0.01,
          f"mean delay {m.mean_delay_rows} rows, expected {EXPECTED_MEAN_DELAY}")
    for f in res.flags._fields:
        check(np.array_equal(getattr(res.flags, f), getattr(ref.flags, f)),
              f"flags.{f} differ between the card and the CPU")
    check(np.array_equal(res.drift_vote, ref.drift_vote), "drift vote differs")
    check(bool(np.isfinite(res.drift_vote).all()), "non-finite drift vote")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    for row in rows:
        row["launches"] = launches[row["name"]]

    times = [api.run(cfg, device=dev) for _ in range(3)]
    final = statistics.median(t.total_time for t in times)
    phases = {k: statistics.median(t.timings[k] for t in times)
              for k in ("upload", "detect", "collect")}
    print(f"Final Time (median of 3 warm runs): {final:.4f} s, "
          f"{prep.stream.num_rows / final:,.0f} rows/s; phases "
          + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items()))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
