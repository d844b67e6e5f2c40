#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and nvcc, and exits non-zero (printing no result)
without them. Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the seventeen hand-written kernels from ``csrc/`` with nvcc (in
   parallel): K1 ``ddm_window``, K2 ``centroid_predict_err``, K7
   ``centroid_fit``, K5-ph ``ph_window``, K5-eddm ``eddm_window``, K5-hddm
   ``hddm_window``, K5-hddm_w ``hddm_w_window``, K5-kswin
   ``kswin_window``, K5-stepd ``stepd_window``, K5-adwin
   ``adwin_window``, K8 ``random_normal``, K9 ``mlp_fit``, K10
   ``mlp_predict_err``, K11 ``forest_fit``, K12 ``forest_predict_err``,
   K6 ``soak_batch`` (``csrc/soak_gen.cu``, ``csrc/xla_sinf.cuh``), K13
   ``shuffle_perm``;
   and the native CSV parser (``native/ddd_native.cc``, with the host C++
   compiler into ``kernels/_build/``);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes — the DDM window statistic (K1) bit for bit at
   [16, 128·100] (fresh and carried states, all-padding rows, the
   DDM_ROBUST noise floor), the centroid predict + error indicator (K2)
   with equal predictions and errors at 16 × 12,800 rows, F = 21, C = 40,
   the centroid fit (K7) bit for bit on the main path's first [16, 100]
   training batch (one class a partition) and on batches of random rows —
   and on the edge cases of their designs (K1: cluster sizes 8 and 1, a
   cluster size that does not divide W, W below it, a CTA of padding only,
   rows of several tiles; K2: near-tie rows, F = 21, 27 and 37, C = 40 and
   64, int16 and int32 indices, and C = 3,000 at F = 21, its classes in
   chunks, equal off the near ties; K7: per_batch 256 and 1000, few and
   many (class, feature) pairs, labels of no class, C = 3,000 at F = 21
   (classes in chunks), and the label layouts of its sorted row list: one
   class, C = 1, B = 1, B = 2049, every label of no class, all weights 0);
   then time each kernel three ways:
   ``ms``, the device time of one launch (50 raw launches through
   ``kernels.launcher`` with preallocated outputs, captured into one CUDA
   graph, replays timed with CUDA events, median of 5 rounds); ``host_us``,
   the wrapper's host cost per call (host clock over 200 calls); and
   ``plain_ms``, the plain version's time per call (CUDA events around 50
   calls, median of 5 rounds). K7 is timed on the main path's first
   training batch, its ``ms`` also on the random rows, beside two
   yardsticks timed as ``ms`` is: ``library_ms``, ``torch.bmm`` of the
   weighted one-hot labels and the rows (the class sums alone), and
   ``floor_ms``, an empty kernel launched with K7's grid, block and shared
   memory;
4. drive the main path, ``run(cfg, device="cuda")`` at bench.py's headline
   geometry (2.048 M rows, 16 partitions, per_batch 100) on the synthetic
   twin of outdoorStream: 624 detections, flags equal field by field to the
   same config run through the port on the CPU, and its three kernels (K1,
   K2, K7) launched (their launch counters are reset just before the run
   and read just after). Final Time is the median of three warm runs;
5. trace one more warm detect phase with ``torch.profiler`` and print
   each kernel's in-run launches and device µs per launch, and the
   device's idle share over the phase;
6. hold each zoo kernel (K5) against its plain version at the main path's
   shape [16, 128·100] and on its design's edge cases, from fresh and
   carried states — Page–Hinkley, HDDM-W, EDDM, HDDM-A, KSWIN and STEPD
   bit for bit (each on its cluster path at P = 16 and P = 1 and with
   clusters of one CTA at P = 80, and on its one-CTA path; for KSWIN and
   STEPD also all-padding rows, rows shorter than their ring buffers, a
   prefix row in the global scratch, and windows of 2,500 that reach back
   over a padding segment into several CTAs and, from a row whose first
   segment is padding, into the carried window; EDDM's sums past 2^24 from
   a fresh and a carried state on both of its paths), ADWIN's int32 state and flags
   exactly — and time it as K1 and K2 are timed (K5-eddm, K5-hddm,
   K5-kswin and K5-stepd with a ``floor_ms``, an empty kernel launched with
   the kernel's grid, cluster, block and dynamic shared memory); for ADWIN
   also the flushes of the timed launch's longest row (its dependent
   chain) and the µs a flush;
7. drive ``detector='ph'``, ``'hddm_w'``, ``'adwin'``, ``'eddm'``,
   ``'hddm'``, ``'kswin'`` and ``'stepd'`` through ``run`` at the same
   geometry, each kernel's launch counter reset just before its run and
   read just after: flags equal to the port's CPU run, detections and mean
   delay equal to the JAX package's (pinned below); Final Time (median of
   3 warm runs) and one traced detect phase each, with the member's
   kernel's own in-run line;
8. drive the ``gnb`` and ``linear`` models and the ``window=1`` engine
   (DDM, Page–Hinkley and EDDM: the kernels at [P, 1, B]) at a smaller
   depth (``mult_data`` 64): flags equal to the port's CPU run, the
   kernels they use launched;
9. the ``mlp`` (MLP(128, 64), 32 steps, the threefry key chain): K8
   bit for bit against its plain version (``split``, then a layer's
   normals) at the main path's init in one launch and on ``K8_EDGES`` (65
   layers in two launches), timed as the whole init with its bound at the
   card's integer rate and a SASS count of a hash's integer operations, K9
   against its plain version (to ``K9_RTOL``/``K9_TIGHT_ATOL`` after 4
   steps, within ``K9_ATOL`` after 32) on the main path's first training
   batch with its fit keys, on random rows and the edge cases (and the
   init bit for bit with no step), and bit for bit against the one-CTA
   kernel it replaced (pinned digests) on that batch at every cluster size and on an F = 27
   batch (and a nine-layer net against its plain version), timed at the
   launcher's cluster size and at each; K10 bit for bit the kernel it replaced
   (pinned digests ``K10_MAIN_DIGEST``, ``K10_F27_DIGEST``) at [16,
   12,800] with the fitted params and on the F = 27 case, at its plan and
   at every plan of ``K10_VARIANTS`` (resident and streamed weights, one
   tile a CTA and persistent CTAs, 64 and 128 rows, 128 and 256 threads),
   its predictions equal to its plain version's off the near ties there
   and on ``K10_EDGES`` (C5's nets, no hidden layer, nine layers, the
   global workspace; each plan printed), timed at each plan, with
   ``library_ms`` (the layers' ``torch.bmm`` alone); each timed as K7 is,
   with a ``floor_ms``; then ``run`` at SMOKE's full width and depth,
   counted: detections equal to the JAX package's and mean delay within a
   batch of it (pinned below), Final Time and one traced detect phase;
   and at a cut depth (``SHALLOW_MULT``) whether the card's flags equal the
   port's CPU run bit for bit (printed, not required);
10. the nets of ROADMAP C5, ``mlp_hidden`` (256, 128) and (512,) (``C5_NETS``),
   through ``run`` at SMOKE on the card, counted: 624 detections and a
   mean delay within a batch of the JAX package's SMOKE value (788.6282
   rows, the CPU run's at this depth), Final Time, K10's plan and one
   traced detect phase each; the CPU reference at a cut depth
   (``SHALLOW_MULT``), counted against the card's run of that depth: the
   same detections and a mean delay within a batch;
11. CSV ingest: SMOKE's stream written as a CSV in the reference's schema
   and run on the card under ``data_policy='strict'`` — the main path's
   624 detections and 788.6282 rows, flags equal field by field to phase
   4's ``synth:`` run, the parser that ran printed — then a dirty copy (a
   NaN cell, a ragged row) under ``quarantine`` and ``repair``, whose
   masked rows ride the dense striper through K1, K2 and K7, counted:
   detections and mean delay equal to the JAX package's CPU run of the
   same file (``DIRTY_EXPECTED``), flags equal to the port's CPU run, Final
   Time (median of 3 warm runs) and the dense stream's upload seconds; and
   (ROADMAP C8) the dirty copy under ``quarantine`` through ``ph``,
   ``hddm_w``, ``adwin``, the ``mlp`` and the ``forest`` at ``C8_MULT``,
   counted, each run's flags equal field by field to its CPU run;
12. wide rows: a centroid run on a CSV of F = 2,048 (K7's features in
   chunks; K2 on its generic path), counted, flags equal to the port's CPU
   run, K7 and K2 timed at its shapes (``wide_ms`` in their rows); K2 at
   F = 60,000 (its features in chunks) against its plain version off the
   near ties, timed;
13. the forest (32 trees of depth 3): K11 and K12 bit for bit against
   their plain versions on the main path's first training batch with its
   fit keys (K12 at [16, 12,800]), on random rows and on
   ``FOREST_EDGES``; each timed as K7 is, with a ``floor_ms`` and its
   layout (K12 also a ``library_ms``: ``torch.bmm`` of the gathered rows
   by every node's projection, the products alone); then
   ``run`` at SMOKE's full width and depth, counted: detections equal to
   the JAX package's and mean delay within a batch of it
   (``FOREST_EXPECTED``), whether the flags equal the port's CPU run
   (printed), Final Time and one traced detect phase;
14. the deep mlp: a net of 65 layers (64 hidden of 16), past the 64 a
   launch's parameters hold: K9's init bit for bit (no step) and its fit
   within ``K9_ATOL`` of its plain version after 2 steps on the main
   path's first batch, K10 equal to its plain version off the near ties,
   then a short run on the card, counted;
15. the paper's experiment loop on the card: the CLI (``python -m
   distributed_drift_detection_tpu_torch`` with the reference's argv on
   SMOKE's CSV twin, ``outdoorStream.csv``) prints the JAX package's line
   ``CLI_EXPECTED`` and a results row ``read_results`` reads back, run
   twice on one fresh ``--compile-cache-dir``, the second loading the
   first's libraries without a rebuild; ``harness.grid.run_grid`` on the
   twin (``GRID_MULTS`` x ``GRID_PARTITIONS`` x ``GRID_TRIALS``, warm-up
   on): 8 trials whose rows equal the same grid's on the CPU but for their
   times, each trial's Final Time and rows/s printed, then a resume that
   runs 0 trials and, with the last row torn halfway, 1; ``rf``, without
   scikit-learn, raises its ``ImportError`` before any allocation on the
   card (with it, a small run's flags equal the CPU's);
   ``harness.parity.measure_delay_parity`` of ``PARITY_MODELS`` on
   ``PARITY_GEOMETRY``: the deterministic families' rows equal the CPU's,
   the mlp's and the forest's detections equal and their mean delays
   within a batch, their kernels launched; ``doctor`` exits 0 on the twin
   and 1 on phase 11's dirty CSV;
16. the sweep as a fleet on the card: (a) ``run`` of SMOKE with a
   ``telemetry_dir``, counted (K1, K2, K7): 624 detections, 788.6282 rows
   and flags equal to phase 4's untelemetered run, every line of its log
   valid under ``telemetry.events.validate_event``, ``memory_snapshot``
   events before and after the detect phase with bytes in use, the
   registry folded to ``completed``; its Final Time beside phase 4's
   median and the seconds its telemetry adds outside the span; (b) the
   ``sched`` scheduler on a 4-cell spec cut from phase 15's grid
   (``GRID_MULTS`` x ``GRID_PARTITIONS``, one trial), 2 spawned
   ``sched-worker`` agents on the card sharing one ``--compile-cache-dir``
   (the directory phase 2 built into): ``audit_exactly_once`` holds and
   each cell's results row equals phase 15's CPU run of it but for its
   times; the sweep's wall time and each worker's start-up seconds; (c)
   crash then heal: ``DDD_FAULTS`` arms ``api.run`` for the second cell of
   a 2-cell telemetered grid; ``heal`` plans exactly that cell and exits 1,
   ``heal --execute`` re-runs only it on the card, counted, and the plan is
   then whole (exit 0);
17. the device-generated soak (``engine/soak.py``) and the capture
   surfaces: (a) K6 bit for bit against its plain version for each
   generator at [128, 2000] (F = 8, 3, 10, 10) and on ``K6_EDGES`` (a batch
   straddling concepts, nonzero concept offsets with partition-local rows,
   rows next to 2^31 − 1, a window chunk's clamped tail, F = 1, a tile
   reaching 38 concepts, C·F past the staging budget, forced staging past
   its slots, B one row past a tile), each in its plan's layout and forced
   to each (``engine/soak.py`` ``k6_plan``), the gradual batch equal to its
   pinned digest (``K6_GRADUAL_DIGEST``), timed in each layout with a
   ``floor_ms``, its bound at the card's integer rate, and each generator
   timed at [128, 2000]; (b) K7 bit for bit and K2 equal off the near
   ties at per_batch 2000 on a K6 batch, timed; (c) the soak at
   ``SOAK_CUT`` for each generator and with ``window`` 8, and a 3-leg chain
   with a checkpoint, counted, flags (the chain: every leg's) equal to the
   port's CPU run; (d) the chain killed by ``DDD_FAULTS=soak.leg`` and
   resumed from its checkpoint to the uninterrupted summary; (e) the
   1e9-row soak at bench.py's geometry (128 partitions x per_batch 2000,
   a concept every 100,000 rows, prototypes, centroid (8, 8), DDM): a 2-leg
   chain (``max_leg_rows`` 2^29) and the one-shot runner on the chain's
   rows find the same detections at the same per-partition positions, as
   many as ``planted_interior_boundaries``; the median delay; rows/s of the
   one-shot (median of 3 warm runs) beside the card's name and power limit;
   K6, K7, K2 and K1 launched (counters reset just before the first timed
   run); one traced window of 50 steps for the idle share; (g) SMOKE with
   ``validate=True``, with a ``profile_dir`` and with a ``trace_dir``: phase
   4's flags, and each Chrome trace names K1, K2 and K7;
18. streaming ingest, the in-loop shuffle and the tenant plane: (a) K13
   (``ops/shuffle.py`` ``shuffle_planes``) bit for bit against its plain
   version at every B of ``K13_BS`` (each path's edges: the warp path to
   1024 with its 32-place floor, the CTA path to 16,384 with the one-round
   edge 1625 and its step to 32 composites a thread at 4097, the global
   path above), P = 16, W = 1 (a key a batch) and W
   = 128 (keys split W ways, each lane's start), int16 and int32 index
   planes, on a 15-batch grid (P = 3, W = 5), and with its draws forced to
   tie on the warp and CTA paths and forced to the global one; the
   library's layout (``shuffle_perm_path``) equal to ``k13_layout`` at
   every B; timed as K7 is at ``K13_TIMED`` — the shuffled window engine's
   launch [16, 128, 100], the window-8 run's [16, 8, 100] and the
   ``window=1`` step's [16, 1, 100] — each with a ``floor_ms`` and its
   bound, the first with
   ``library_ms`` (``torch.sort(stable=True)`` of the draws: the sort
   only); the K13 line names the path and batches a CTA that
   ``k13_layout`` gives; (b) SMOKE's stream written as a 2,048,000-row
   CSV, ``csv_chunks`` → ``prefetch_chunks`` → ``api.prepare_chunked``
   (W = 128, R = 4, ``CHUNK_BATCHES`` a chunk) with 1 and 4 ingest
   workers, counted: 624 detections and phase 4's flags field by field,
   rows/s end to end (parse included) and the stage breakdown; the
   ``chunked`` CLI on the same CSV, 624 detections with 1 and 4 workers;
   (c) ``ChunkedDetector(shuffle=True)`` at ``SHUFFLE_MULT`` with window 1
   and with window 8, R = 2, counted: flags equal to the same run on the
   CPU, K13 launched; K13's in-run µs from one traced chunk; (d) a
   checkpoint after chunk 2 restored into a fresh detector: the remaining
   flags equal the uninterrupted run's; (e) ``run_multi`` of ``TENANTS``
   tenants at SMOKE, counted: each tenant's flags and vote equal to its
   solo run (tenant 0's to phase 4's), each tenant's votes and metrics
   printed, the stacked Final Time and rows/s;
19. the serving daemon (``serve.runner.ServeRunner`` on the card, W =
   128, R = 4): (a) SMOKE's stream replayed by ``serve.loadgen.run_loadgen``
   over loopback as wire v2 frames into a daemon with an ingress port, an
   ops port and a telemetry dir (forensics and incidents on), ``CHUNK_BATCHES``
   a chunk, counted: 624 detections, the ``change_global`` table rebuilt
   from the verdict sidecar and the kept flags equal to phase 4's, one
   forensics bundle per drift verdict, ``/healthz`` 200, ``/metrics``
   carrying ``serve_row_latency_seconds_bucket``, K1, K2 and K7 launched
   while serving and K13 on neither the main path nor the serving path
   (counters reset just before the replay); printed beside the card's name
   and power limit: admission rows/s (the client's send), served rows/s
   (first row sent to the last verdict), p50/p99 row→verdict latency by
   stage, ``serve_stage_busy_seconds_total`` by stage, the drain's
   seconds; (b) at ``SHALLOW_MULT`` under ``quarantine``, replayed as v1
   text with ``SERVE_DIRTY`` rows: flags equal to ``api.run`` on the card
   with those rows masked, the quarantine sidecar naming exactly them; (c)
   ``checkpoint_every=1`` and ``serve.flush`` armed to raise at chunk 2,
   then a fresh daemon resumed from the checkpoint fed the rest: the union
   of the verdicts equals (a)'s; (d) ``TENANTS`` slots at ``SHALLOW_MULT``:
   each slot's flags equal its tenant's solo daemon's; ``SAVETENANT`` of
   slot 1 after two chunks, ``LOADTENANT`` into a fresh daemon: that
   tenant's flags continue bit for bit; (e) ``python -m
   distributed_drift_detection_tpu_torch serve`` as a process on the card,
   fed by the ``loadgen`` CLI, then 7 rows without ``FLUSH`` and SIGTERM:
   exit 0, the partial microbatch published, the registry ``completed``;
20. drift adaptation and the tenant router: (a) SMOKE served as in 19 (a)
   with ``--on-drift retrain,window_rows=12800``, counted: an adaptation
   applied, every refit's K7 output bit for bit the plain version's fit of
   the same window on the card, the ``adaptation`` events, the snapshot and
   ``adaptations_total`` in agreement, the verdicts through the first
   applied adaptation's chunk equal to 19 (a)'s, K7 and K2 launched by the
   adaptation itself (counters read around each ``on_chunk``); printed
   beside the card's name and power limit: the adaptations applied, the
   ``adapt`` stage's busy seconds, K7 at [1, 12800, 21] and K2 at [32,
   12800] (µs a launch, graphs of 50, with their bounds) and served rows/s
   against 19 (a)'s; (b) ``shadow,window_rows=12800,margin=0.0`` at
   ``SHALLOW_MULT``, 8 batches a chunk, a promotion and a demotion in the
   stream: verdicts, adaptation events and recovery rows equal to the
   port's CPU daemon; (c) ``FLEET_TENANTS`` tenants placed by
   ``plan_fleet`` over two ``serve`` processes on the card with
   ``FLEET_SPARES`` vacant slots each, fed by ``run_loadgen`` through the
   router (``--router``: global ids, v2 frames) in three cuts: a graceful
   ``migrate_tenant`` after the first, ``SIGKILL`` of one daemon after the
   second (its tenant fails over from its ``--tenant-checkpoints``
   checkpoint); each tenant's verdict entries equal the unmoved plane's,
   lost rows 0 in the router's journal; the router's rows/s by cut, the
   migration's pause and the failover's seconds printed.

The line before the last is a JSON object listing each kernel's launches,
error, times and bound; the last line is the device JSON.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
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
# The JAX package's run of SMOKE with each zoo kernel's detector:
# (detections, mean delay in rows).
ZOO_EXPECTED = {"ph": (624, 820.8077), "hddm_w": (624, 781.6282),
                "adwin": (624, 792.7051), "eddm": (624, 803.3974), "hddm": (624, 770.6795),
                "kswin": (624, 809.1154), "stepd": (624, 788.6282)}
# The zoo's paths at SMOKE width: (detector, its kernel).
ZOO_PATHS = [("ph", "ph_window"), ("hddm_w", "hddm_w_window"), ("adwin", "adwin_window"),
             ("eddm", "eddm_window"), ("hddm", "hddm_window"), ("kswin", "kswin_window"),
             ("stepd", "stepd_window")]
# The JAX package's run of SMOKE with model='mlp' (MLP(128, 64), 32 steps,
# ddm): (detections, mean delay in rows). Its fits cannot match XLA's to
# the bit, so the bar is equal detections and a mean delay within a batch.
MLP_EXPECTED = (624, 788.6282051282051)
# Runs at a smaller depth: (name, RunConfig overrides, kernels launched).
SHALLOW = [
    ("gnb", dict(model="gnb"), ("ddm_window",)),
    ("linear", dict(model="linear"), ("ddm_window", "centroid_predict_err")),
    ("window=1 ddm", dict(window=1), ("ddm_window", "centroid_predict_err", "centroid_fit")),
    ("window=1 ph", dict(window=1, detector="ph"),
     ("ph_window", "centroid_predict_err", "centroid_fit")),
    ("window=1 eddm", dict(window=1, detector="eddm"),
     ("eddm_window", "centroid_predict_err", "centroid_fit")),
]
SHALLOW_MULT = 64
# The mlp's nets of ROADMAP C5, run end to end at SMOKE beside the main
# path's: K10 streams their weights through its ring.
C5_NETS = [(256, 128), (512,)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
# H100 SXM: 64 results of a 32-bit integer add, shift or bitwise operation a
# clock an SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# The 32-bit integer operations of one threefry2x32 hash and its bits, as
# nvcc compiles them for sm_90a (cuobjdump -sass of K6 and K8 on an H100):
# 20 rotates (SHF.L.W), 21 xors (LOP3, the key schedule's included), 27
# adds (IADD3, some as IMAD.IADD; the key injections merged into 3-input
# adds) and the bits' xor. `sass_hash_ops` prints the count in each run.
HASH_INT_OPS = 20 + 21 + 27 + 1
# f32 operations of erf_inv as XLA's CPU code forms it (csrc/threefry.cuh
# `xla_erfinvf`: log1p's rational or logf, a nine-term polynomial) and of a
# uniform's map
ERFINV_F32_OPS, UNIFORM_F32_OPS = 40, 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` calls, between
    CUDA events on the host's stream: host-bound for a fast kernel behind
    a slow wrapper, so it times only the plain versions."""
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


def graph_ms(launch, reps: int = 50, rounds: int = 5) -> float:
    """Device time of one ``launch()``: ``reps`` calls captured into one
    CUDA graph, each replay timed with CUDA events; the median over
    ``rounds`` replays, divided by ``reps``. ``launch`` must enqueue only
    the kernel (outputs preallocated), so the graph holds nothing else."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def host_us(fn, calls: int = 200, rounds: int = 5) -> float:
    """The host's cost of one ``fn()`` call, in µs: the host clock over
    ``calls`` calls (no synchronize inside), divided by their number; the
    median over ``rounds`` rounds, each after a synchronize."""
    import torch

    fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def bound(nbytes: float, ops: float, int_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of device memory, ``ops`` f32
    operations and ``int_ops`` 32-bit integer operations, each at the
    card's rate, and which bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sass_hash_ops(library: str, symbol: str) -> "dict | None":
    """The SASS of kernel ``symbol`` in ``library`` (``cuobjdump -sass``):
    its threefry hashes (20 rotates each: ``SHF.*.W``, or ``PRMT`` where a
    rotate is by whole bytes) and its integer adds, funnel shifts, byte
    permutes and three-input logic ops (IADD3, IMAD.IADD, SHF, PRMT, LOP3) a
    hash, to hold against ``HASH_INT_OPS`` — an upper count of a hash's own,
    since addressing and the map's bit work use the same opcodes. None where
    cuobjdump is missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          timeout=120).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = "\n".join(f for f in funcs[1:] if symbol in f.splitlines()[0])
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)(\.[\w.]+)?", body)
    # a rotate is a wrapping funnel shift, or a byte permute (by 16 or 24)
    rotates = sum(1 for op, mod in ops if op == "PRMT" or op == "SHF" and ".W" in (mod or ""))
    ints = sum(1 for op, mod in ops
               if op in ("IADD3", "SHF", "LOP3", "PRMT") or op == "IMAD" and mod == ".IADD")
    hashes = rotates / 20
    return {"instructions": len(ops), "hashes": hashes,
            "int_ops_a_hash": ints / hashes if hashes else None}


def ddm_inputs(rng, p, w, b):
    """Bernoulli error indicators with per-partition rate jumps; ragged
    padding, partition 1 all padding, and in partition 0 the batches
    [W/4, W/2) all padding (whole CTAs of a cluster of 8)."""
    n = w * b
    flip = rng.integers(0, n, p)[:, None]
    rate = np.where(np.arange(n)[None] < flip, rng.uniform(0, 0.05, (p, 1)),
                    rng.uniform(0.2, 0.9, (p, 1)))
    errs = (rng.random((p, n)) < rate).astype(np.float32).reshape(p, w, b)
    valid = rng.random((p, w, b)) < 0.98
    if p > 1:
        valid[1] = False
    if p > 3:
        valid[3, w // 2:] = False
    valid[0, w // 4: w // 2] = False
    return errs, valid


# K1 edge cases (P, W, B): cluster sizes 8 (P=1) and 1 (P=200); cluster
# sizes that do not divide W (7, 130); W below the cluster size (5 < 8);
# slices of several 2048-element tiles (P=67: cs=1, 5200 elements a CTA).
K1_EDGES = [(1, 128, 100), (200, 7, 20), (16, 130, 20), (1, 5, 30),
            (3, 7, 33), (67, 40, 130)]


def k1_cases(torch, ddm, params_mod, p, w, b, dev, rng):
    """(name, params, carried state, errs, valid) at [P, W, B] for the
    three parameter sets; the carried state is the plain version's over an
    earlier window (the 'warmup' one has +inf minima with a payload)."""
    cases = {
        "classic": params_mod.DDMParams(),
        "robust": params_mod.DDM_ROBUST,
        "warmup": params_mod.DDMParams(min_num_instances=500),
    }
    out = []
    for name, prm in cases.items():
        e0, v0 = (torch.from_numpy(a).to(dev) for a in ddm_inputs(rng, p, 1, 300))
        e1, v1 = (torch.from_numpy(a).to(dev) for a in ddm_inputs(rng, p, w, b))
        carried, _ = ddm.ddm_window_reference(ddm.ddm_init((p,), dev), e0, v0, prm)
        out.append((name, prm, carried, e1, v1))
    return out


def check_k1_equal(torch, ddm, prm, state, e1, v1, what):
    got = ddm.ddm_window(state, e1, v1, prm)
    want = ddm.ddm_window_reference(state, e1, v1, prm)
    torch.cuda.synchronize()
    for g, r in zip(got[0] + got[1], want[0] + want[1]):
        check(torch.equal(g.view(torch.int32), r.view(torch.int32)),
              f"K1 differs from its plain version ({what})")


def check_k1(torch, ddm, kernels, params_mod, p, w, b, dev):
    """K1 against its plain version, bit for bit, at the main path's shape
    and the edge cases; times it; returns its kernel row."""
    rng = np.random.default_rng(1)
    for shape in [(p, w, b)] + K1_EDGES:
        for name, prm, carried, e1, v1 in k1_cases(torch, ddm, params_mod, *shape, dev, rng):
            if name == "warmup" and shape == (p, w, b):
                check(bool((torch.isinf(carried.ps_min) & torch.isfinite(carried.p_min)).any()),
                      "K1 inputs miss a carried inf state with a finite payload")
            for state in (ddm.ddm_init((shape[0],), dev), carried):
                check_k1_equal(torch, ddm, prm, state, e1, v1, f"{name} {shape}")
    print(f"K1 ddm_window: bitwise equal at [{p}, {w}x{b}] and "
          + ", ".join(f"[{a}, {c}x{d}] (cs={ddm.cluster_size(a)})" for a, c, d in K1_EDGES))

    # timed: the classic case at the main path's shape, from a carried state
    _, prm, state, e1, v1 = k1_cases(torch, ddm, params_mod, p, w, b, dev,
                                     np.random.default_rng(1))[0]
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty_like(fw)
    end = ddm.DDMState(*(torch.empty_like(leaf) for leaf in state))
    args = ddm.ddm_window_args(state, e1, v1, prm, fw, fc, end)
    fn = kernels.launcher("ddm_window")
    ms = graph_ms(lambda: kernels.check(
        "ddm_window", fn(*args, kernels.stream_handle(dev))))
    h_us = host_us(lambda: ddm.ddm_window(state, e1, v1, prm))
    plain_ms = time_ms(lambda: ddm.ddm_window_reference(state, e1, v1, prm))
    n = p * w * b
    # each input read once (errs f32, live u8, 5 state leaves), each output
    # written once ([P, W] i32 twice, 5 state leaves); ~14 f32 operations a
    # element (2 divisions, sqrt, 2 FMAs, adds, compares)
    b_ms, by = bound(n * 5 + p * 5 * 4 * 2 + p * w * 8, n * 14)
    print(f"K1 ddm_window [{p}, {w}x{b}] cs={ddm.cluster_size(p)}: {ms:.5f} ms "
          f"device (graph of 50), {h_us:.1f} us host a call, {plain_ms:.4f} ms "
          f"plain, bound {b_ms:.5f} ms ({by})")
    return dict(
        name="ddm_window", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/ddm_window.cu",
        replaces="distributed_drift_detection_tpu/ops/ddm.py:277",
        max_abs_err=0.0, ms=ms, host_us=h_us, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=by, library_ms=None,
    )


def k2_inputs(rng, base_X, base_y, p, n, c, idx_dtype=np.int16):
    """Centroids near the class means of ``base_X``, a quarter of the
    classes absent per partition, partition 0 with every class absent (all
    -inf rows), and random gather indices: numpy arrays."""
    f = base_X.shape[1]
    ky = base_y % c
    means = np.stack([base_X[ky == k].mean(0) if (ky == k).any()
                      else np.zeros(f, np.float32) for k in range(c)])
    cent = (means[None] + 0.05 * rng.normal(size=(p, c, f))).astype(np.float32)
    bias = (-0.5 * (cent.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    bias[rng.random((p, c)) < 0.25] = -np.inf
    bias[0] = -np.inf
    idx = rng.integers(0, len(base_y), (p, n)).astype(idx_dtype)
    return cent, bias, base_X, ky.astype(np.int32), idx


def tie_inputs():
    """C = 5, F = 6: class 0 absent, classes 1 and 3 identical (an exact
    tie: the first wins), class 4 a hair from class 2, and rows that sit
    5e-5 from the 2/4 tie on either side; expected predictions."""
    c, f = 5, 6
    cent = np.zeros((c, f), np.float32)
    cent[1] = cent[3] = 1.0
    cent[2] = cent[4] = 2.0
    cent[4, 0] = 2.001
    bias = (-0.5 * (cent * cent).sum(1)).astype(np.float32)
    bias[0] = -np.inf
    rows = np.stack([np.full(f, 1.0), np.r_[2.05, np.full(f - 1, 2.0)],
                     np.r_[1.95, np.full(f - 1, 2.0)]]).astype(np.float32)
    want = np.array([1, 4, 2], np.int32)
    return cent[None], bias[None], rows, want


def check_k2_equal(torch, classifiers, arrays, dev, what):
    cent, bias, T, Ty, idx = (torch.from_numpy(a).to(dev) for a in arrays)
    err, pred = classifiers.centroid_predict_err(cent, bias, T, Ty, idx, return_pred=True)
    rerr, rpred = classifiers.centroid_predict_err_reference(cent, bias, T, Ty, idx)
    torch.cuda.synchronize()
    check(torch.equal(pred, rpred), f"K2 predictions differ from its plain version ({what})")
    check(torch.equal(err, rerr), f"K2 errors differ from its plain version ({what})")
    return err, pred, rerr


def check_k2_chunks(torch, classifiers, rng, dev):
    """K2 at C = 3,000 classes, F = 21 — more than shared memory holds at
    once (2,058), so its classes run in chunks: predictions equal to its
    plain version's off the near ties (the two best float64 scores within
    1e-4·(1 + |top|): the kernel's dot chain and torch.bmm sum in other
    orders), errors ``pred != y``. Returns the near ties' count."""
    ec, ef = 3000, 21
    protos = rng.normal(size=(ec, ef)).astype(np.float32) * 3
    ty = rng.integers(0, ec, 6000).astype(np.int32)
    table = (protos[ty] + 0.3 * rng.normal(size=(6000, ef))).astype(np.float32)
    cent, bias, T, Ty, idx = (torch.from_numpy(a).to(dev)
                              for a in k2_inputs(rng, table, ty, 4, 3000, ec, np.int32))
    err, pred = classifiers.centroid_predict_err(cent, bias, T, Ty, idx, return_pred=True)
    _, rpred = classifiers.centroid_predict_err_reference(cent, bias, T, Ty, idx)
    scores = (T[idx.long()].double() @ cent.double().transpose(1, 2)
              + bias.double()[:, None])
    top2 = scores.topk(2, -1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 1e-4 * (1 + top2[..., 0].abs())
    check(torch.equal(pred[~tie], rpred[~tie]),
          "K2 predictions differ from its plain version off the near ties (C=3000)")
    check(torch.equal(err, (pred != Ty[idx.long()]).float()), "K2 errors are not pred != y (C=3000)")
    return int(tie.sum())


def check_k2(torch, classifiers, kernels, stream, p, w, b, dev):
    """K2 against its plain version — equal preds and errs — at the main
    path's shape and the edge cases; times it; returns its kernel row."""
    rng = np.random.default_rng(2)
    c, f = stream.num_classes, stream.num_features
    arrays = k2_inputs(rng, stream.base_X, stream.base_y, p, w * b, c)
    err, _, rerr = check_k2_equal(torch, classifiers, arrays, dev, "main path")
    check(bool((err > 0).any()) and bool((err == 0).any()), "K2 inputs give one error value only")
    max_err = float((err - rerr).abs().max())

    edges = []
    for ef, ec, dt in [(21, 40, np.int32), (27, 40, np.int16), (27, 64, np.int32),
                       (37, 64, np.int16), (37, 40, np.int32)]:
        protos = rng.normal(size=(ec, ef)).astype(np.float32) * 3
        ty = rng.integers(0, ec, 3000).astype(np.int32)
        table = (protos[ty] + 0.3 * rng.normal(size=(3000, ef))).astype(np.float32)
        check_k2_equal(torch, classifiers, k2_inputs(rng, table, ty, 4, 3000, ec, dt),
                       dev, f"F={ef} C={ec} {np.dtype(dt).name}")
        edges.append(f"F={ef} C={ec} {np.dtype(dt).name}")
    ties = check_k2_chunks(torch, classifiers, rng, dev)
    edges.append(f"F=21 C=3000 int32 (classes in chunks; {ties} near ties)")
    cent, bias, rows, want = tie_inputs()
    for dt in (np.int16, np.int32):
        idx = np.arange(len(rows), dtype=dt)[None]
        _, pred, _ = check_k2_equal(torch, classifiers, (cent, bias, rows, want, idx),
                                    dev, "near ties")
        check(np.array_equal(pred.cpu().numpy()[0], want), "K2 near-tie predictions")
    print(f"K2 centroid_predict_err: preds and errs equal at [{p}, {w * b}] "
          f"F={f} C={c}, near ties, " + ", ".join(edges))

    cent_t, bias_t, T, Ty, idx_t = (torch.from_numpy(a).to(dev) for a in arrays)
    Tp = classifiers.pad_row_table(T)
    err_buf = torch.empty(idx_t.shape, dtype=torch.float32, device=dev)
    args = classifiers.centroid_predict_err_args(cent_t, bias_t, Tp, Ty, idx_t, err_buf)
    fn = kernels.launcher("centroid_predict_err")
    ms = graph_ms(lambda: kernels.check(
        "centroid_predict_err", fn(*args, kernels.stream_handle(dev))))
    h_us = host_us(lambda: classifiers.centroid_predict_err(cent_t, bias_t, Tp, Ty, idx_t))
    plain_ms = time_ms(
        lambda: classifiers.centroid_predict_err_reference(cent_t, bias_t, T, Ty, idx_t))
    rows_n = p * w * b
    # idx i16 + err f32 per row, the row table and labels, centroids + bias;
    # 2·F·C operations a row for the dot products
    nbytes = rows_n * 6 + T.numel() * 4 + Ty.numel() * 4 + cent_t.numel() * 4 + bias_t.numel() * 4
    b_ms, by = bound(nbytes, rows_n * 2 * f * c)
    print(f"K2 centroid_predict_err [{p}, {w * b}] F={f} C={c}: {ms:.5f} ms "
          f"device (graph of 50), {h_us:.1f} us host a call, {plain_ms:.4f} ms "
          f"plain, bound {b_ms:.5f} ms ({by})")
    return dict(
        name="centroid_predict_err", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/centroid_predict_err.cu",
        replaces="distributed_drift_detection_tpu/models/classifiers.py:100",
        max_abs_err=max_err, ms=ms, host_us=h_us, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=by, library_ms=None,
    )


# K7 edge cases (P, B, F, C): per_batch 256 and 1000 (one row tile each),
# C·(F + 1) below one warp, 16,448 (class, feature) pairs, more than a
# block's threads, whose shared memory halves the row tile, and C = 3,000
# at F = 21, more classes than shared memory holds at once (2,490): its
# classes in chunks, at one row tile of 100 and of 1,000.
K7_EDGES = [(4, 256, 27, 5), (3, 1000, 21, 40), (2, 7, 3, 4), (1, 300, 256, 64),
            (3, 100, 21, 3000), (2, 1000, 21, 3000)]
# and the label layouts of its sorted row list, (P, B, F, C) each: every
# row of one class (a chain of B), C = 1, B = 1 (XLA's product), three row
# tiles of 1024 (B = 2049), every label outside [0, C), all weights 0.
K7_LAYOUTS = {"one class": (4, 100, 21, 40), "C=1": (3, 100, 21, 1),
              "B=1": (16, 1, 21, 40), "B=2049": (2, 2049, 21, 40),
              "no class": (4, 100, 21, 40), "weights 0": (4, 100, 21, 40)}


def k7_inputs(rng, base_X, base_y, p, b, c):
    """A training batch per partition gathered from the row table (labels
    taken mod C, every partition missing its last class), {0, 1} weights,
    and a few labels of no class (C): numpy arrays."""
    idx = rng.integers(0, len(base_y), (p, b))
    X = base_X[idx].astype(np.float32)
    y = (base_y[idx] % max(c - 1, 1)).astype(np.int32)
    y[rng.random((p, b)) < 0.02] = c
    w = (rng.random((p, b)) < 0.98).astype(np.float32)
    return X, y, w


def k7_main_batch(batches):
    """The main path's first training batch of each partition — the rows
    of the packed stream's first batch, their labels and validity weights
    (``engine/loop.py`` ``expand_packed`` at slot 0): numpy arrays. On
    SMOKE's stream every batch holds one class."""
    idx = np.asarray(batches.idx)
    p = idx.shape[0]
    i0 = idx[:, 0].astype(np.int64)
    gmap = np.asarray(batches.perm)[:, 0].astype(np.int64) * p + np.arange(p)[:, None]
    return (np.asarray(batches.base_X)[i0], np.asarray(batches.base_y)[i0].astype(np.int32),
            (gmap < int(batches.n_rows)).astype(np.float32))


def k7_layout(rng, base_X, base_y, name):
    """``k7_inputs`` at the layout's shape, then its labels or weights."""
    p, b, _, c = K7_LAYOUTS[name]
    X, y, w = k7_inputs(rng, base_X, base_y, p, b, c)
    if name == "one class":
        y[:] = 7
    elif name == "no class":
        y[:] = np.where(np.arange(b) % 2 == 0, c, -3)
    elif name == "weights 0":
        w[:] = 0.0
    return X, y, w


def check_k7_equal(torch, classifiers, arrays, c, dev, what, last_absent=True):
    X, y, w = (torch.from_numpy(a).to(dev) for a in arrays)
    got = classifiers.centroid_fit(X, y, w, c)
    want = classifiers.centroid_fit_reference(X, y, w, c)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        check(torch.equal(g.view(torch.int32), r.view(torch.int32)),
              f"K7 differs from its plain version ({what})")
    if last_absent:
        check(bool(torch.isinf(got.bias[:, -1]).all()),
              f"K7: an absent class is not -inf ({what})")


def check_k7(torch, classifiers, kernels, prep, p, b, dev):
    """K7 against its plain version, bit for bit, on the main path's first
    training batch, on [P, per_batch] batches of random rows of the SMOKE
    stream, the edge cases and the label layouts; times it on the main
    path's batch (and on the random rows), with two yardsticks; returns
    its kernel row."""
    rng = np.random.default_rng(7)
    stream = prep.stream
    c, f = stream.num_classes, stream.num_features
    main = k7_main_batch(prep.batches)
    classes = max(len(np.unique(yq)) for yq in main[1])
    check_k7_equal(torch, classifiers, main, c, dev, "main path", last_absent=False)
    arrays = k7_inputs(rng, stream.base_X, stream.base_y, p, b, c)
    check_k7_equal(torch, classifiers, arrays, c, dev, "random rows")

    def table(ef, ec):
        protos = rng.normal(size=(ec, ef)).astype(np.float32) * 3
        ty = rng.integers(0, ec, 2000).astype(np.int32)
        return (protos[ty] + 0.5 * rng.normal(size=(2000, ef))).astype(np.float32), ty

    for ep, eb, ef, ec in K7_EDGES:
        check_k7_equal(torch, classifiers, k7_inputs(rng, *table(ef, ec), ep, eb, ec), ec,
                       dev, f"P={ep} B={eb} F={ef} C={ec}")
    for name, (_, _, ef, ec) in K7_LAYOUTS.items():
        check_k7_equal(torch, classifiers, k7_layout(rng, *table(ef, ec), name), ec, dev,
                       name, last_absent=ec > 1)
    print(f"K7 centroid_fit: bitwise equal on the main path's first batch [{p}, {b}] "
          f"F={f} C={c} (classes a partition: at most {classes}) and on random rows, and at "
          + ", ".join(f"P={a} B={d} F={e} C={g}" for a, d, e, g in K7_EDGES)
          + ", label layouts " + ", ".join(f"{k} {v}" for k, v in K7_LAYOUTS.items()))

    fn = kernels.launcher("centroid_fit")
    cent = torch.empty((p, c, f), dtype=torch.float32, device=dev)
    bias = torch.empty((p, c), dtype=torch.float32, device=dev)

    def graph_of(batch):
        args = classifiers.centroid_fit_args(*batch, cent, bias)
        return graph_ms(lambda: kernels.check("centroid_fit", fn(*args, kernels.stream_handle(dev))))

    random_ms = graph_of([torch.from_numpy(a).to(dev) for a in arrays])
    X, y, w = (torch.from_numpy(a).to(dev) for a in main)
    ms = graph_of((X, y, w))
    h_us = host_us(lambda: classifiers.centroid_fit(X, y, w, c))
    plain_ms = time_ms(lambda: classifiers.centroid_fit_reference(X, y, w, c), reps=10, rounds=3)
    # X f32, y i32 and w f32 read once, centroids and biases written once;
    # each weighted row added into its class (F + 1 adds), a division a
    # centroid element and an FMA a bias term
    b_ms, by = bound(p * b * (f + 2) * 4 + p * c * (f + 1) * 4,
                     p * b * (f + 1) + 2 * p * c * f)
    print(f"K7 centroid_fit [{p}, {b}] F={f} C={c}: {ms:.5f} ms device (graph of 50), "
          f"{h_us:.1f} us host a call, {plain_ms:.4f} ms plain, bound {b_ms:.5f} ms ({by}); "
          f"on random rows (about {b / c:.1f} rows a class) {random_ms:.5f} ms")
    # yardsticks: the one PyTorch call for the class sums, bmm(onehot·wᵀ, X)
    # (the sums only, in cuBLAS's order), and an empty kernel launched with
    # K7's grid, block and shared memory
    ok = (y >= 0) & (y < c)
    onehot = torch.zeros((p, b, c), dtype=torch.float32, device=dev)
    onehot.scatter_(2, torch.where(ok, y, 0).long()[..., None], (w * ok)[..., None])
    onehot_t = onehot.transpose(1, 2).contiguous()
    sums = torch.empty((p, c, f), dtype=torch.float32, device=dev)
    lib_ms = graph_ms(lambda: torch.bmm(onehot_t, X, out=sums))
    floor = kernels.launcher("centroid_fit_floor")
    floor_ms = graph_ms(lambda: kernels.check(
        "centroid_fit_floor", floor(p, b, f, c, kernels.stream_handle(dev))))
    print(f"K7 centroid_fit yardsticks: library {lib_ms:.5f} ms (torch.bmm(onehot_wT, X), "
          f"the class sums only, not in row order), floor {floor_ms:.5f} ms (an empty "
          "kernel with K7's grid, block and shared memory; graphs of 50)")
    return dict(
        name="centroid_fit", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/centroid_fit.cu",
        replaces="distributed_drift_detection_tpu/models/classifiers.py:92",
        max_abs_err=0.0, ms=ms, host_us=h_us, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=by, library_ms=lib_ms, floor_ms=floor_ms,
        random_rows_ms=random_ms,
    )


# --------------------------------------------------------------------------
# the MLP's kernels: K8 random_normal, K9 mlp_fit, K10 mlp_predict_err
# --------------------------------------------------------------------------

# K9 against its plain version (the bounds tests/test_torch_kernels.py
# states): the two sum their products in other orders, and over a fit's
# steps a hidden unit's input within rounding of zero flips its ReLU
# gradient in one version only, after which that partition's trajectories
# part. Held after 4 steps to rtol 1e-4 / atol 2e-6, after all to 5e-2.
K9_RTOL, K9_TIGHT_ATOL, K9_TIGHT_STEPS = 1e-4, 2e-6, 4
K9_ATOL = 5e-2
# K9 edge cases (P, B, F, C, hidden, steps): B not a multiple of 32 with
# C = 5, F = 27 (≈ 223 KB of shared memory), a batch too large for shared
# memory (the global workspace), narrow widths, nine layers.
K9_EDGES = [(4, 37, 27, 5, (128, 64), 32), (4, 100, 27, 40, (128, 64), 32),
            (3, 300, 21, 40, (128, 64), 8), (4, 50, 21, 40, (16, 8), 4),
            (2, 64, 21, 40, (32,) * 8, 8)]


# K9's fit is bit for bit the same at every cluster size and tile shape: the
# SHA-256 of the fitted parameters' bytes (``params_digest``) that the
# one-CTA kernel of commit b2a30dd gives on the main path's first training batch with
# its fit keys after 32 steps, and on the F = 27 batch ``k9_f27_batch``
# (NVIDIA H100 80GB HBM3; chip_kernel_ab.py against b2a30dd).
K9_MAIN_DIGEST = "72f2a6a1ae3765feea944798cef28d7621e943e5d030bc91967eefc70cc3f39b"
K9_F27_DIGEST = "bc1b93f25051df4a7dd30711650a558997fb0156b2df6ea148d1155d8dae4717"
# the F = 27 batch's shape (P, B, F, C, hidden, steps); its rows are
# ``k9_f27_batch``'s
K9_F27 = (4, 100, 27, 40, (128, 64), 32)


def params_digest(params) -> str:
    """SHA-256 of the fitted parameters' bytes, layer by layer (w, then b)."""
    h = hashlib.sha256()
    for layer in params:
        for t in layer:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def k9_f27_batch(seed: int = 27):
    """K9's F = 27 batch (``K9_F27``): rows around C prototypes, labels,
    {0, 1} weights with every third row of partition 0 invalid."""
    p, b, f, c, _, _ = K9_F27
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(c, f)).astype(np.float32) * 2
    y = rng.integers(0, c, (p, b)).astype(np.int32)
    X = (protos[y] + 0.5 * rng.normal(size=(p, b, f))).astype(np.float32)
    w = (rng.random((p, b)) < 0.9).astype(np.float32)
    w[0, ::3] = 0.0
    return X, y, w


def mlp_dims(stream, cfg):
    return (stream.num_features, *cfg.mlp_hidden, stream.num_classes)


def mlp_keys(torch, prep, dev):
    """The main path's first init keys and first fit keys (level 0 of the
    window engine's first iteration), as the engine draws them."""
    from distributed_drift_detection_tpu_torch.engine.loop import device_keys
    from distributed_drift_detection_tpu_torch.utils import threefry

    p, r = prep.config.partitions, prep.config.window_rotations
    pair = threefry.split(threefry.split(threefry.key(prep.config.seed), p), 2)
    _, fit = threefry.window_fit_keys(pair[:, 0], 1, r)
    return device_keys(pair[:, 1], dev), device_keys(fit[0, 0], dev)


def mlp_fit_ops(dims, b, steps):
    """f32 operations of one partition's fit: per step the forward
    products, the weight gradients and the backward products (2 a
    multiply-add), the rest of a step being O(B·width)."""
    macs = sum(a * c for a, c in zip(dims[:-1], dims[1:]))
    back = sum(a * c for a, c in zip(dims[1:-1], dims[2:]))
    return 2 * steps * b * (2 * macs + back)


# K8 beyond the main path's init, (P, dims): 65 layers (two launches, the
# second's split counters from 64), a layer of one normal, 3 partitions
K8_EDGES = [(2, (7,) * 65 + (2,)), (3, (1, 1, 2)), (3, (5, 16, 8, 3))]


def init_ops(p, dims):
    """(bytes, f32 operations, integer operations) of the MLP init:
    every weight and bias written once, the keys read; a split a (layer,
    partition) and a hash and a normal's map a weight."""
    normals = p * sum(a * c for a, c in zip(dims[:-1], dims[1:]))
    hashes = p * (len(dims) - 1) + normals
    nbytes = 4 * (normals + p * sum(dims[1:])) + 8 * p
    return nbytes, normals * (ERFINV_F32_OPS + UNIFORM_F32_OPS), hashes * HASH_INT_OPS


def check_k8(torch, kernels, mlp, threefry, prep, dev):
    """K8 against its plain version, bit for bit: the main path's init (16
    keys, MLP(128, 64)) in one launch, and K8_EDGES; times the init's
    launch; returns its kernel row."""
    dims = mlp_dims(prep.stream, prep.config)
    init_keys, _ = mlp_keys(torch, prep, dev)
    p = init_keys.shape[0]
    cases = [(init_keys, dims)] + [(init_keys[:q].contiguous(), d) for q, d in K8_EDGES]
    for keys, d in cases:
        before = threefry.init_normals.launches
        got = mlp.mlp_init(keys, d)
        torch.cuda.synchronize()
        want = mlp.mlp_init(keys.cpu(), d, normal=threefry.random_normal_reference)
        check(threefry.init_normals.launches - before == -(-(len(d) - 1) // 64),
              f"K8: {threefry.init_normals.launches - before} launches for {len(d) - 1} layers")
        check(all(torch.equal(g.w.cpu().view(torch.int32), r.w.view(torch.int32))
                  and torch.equal(g.b.cpu(), r.b) for g, r in zip(got, want)),
              f"K8 differs from its plain version (P = {keys.shape[0]}, {len(d) - 1} layers)")
    print(f"K8 random_normal: bit for bit its plain version at the main path's init ({p} keys, "
          f"dims {dims}, one launch) and at " + ", ".join(
              f"P = {q}, {len(d) - 1} layers" for q, d in K8_EDGES))

    counts = [a * c for a, c in zip(dims[:-1], dims[1:])]
    factors = mlp.init_scales(dims)
    zeros = p * sum(dims[1:])
    ms = graph_ms(lambda: threefry.init_normals(init_keys, counts, factors, zeros))
    h_us = host_us(lambda: mlp.mlp_init(init_keys, dims))
    plain_ms = time_ms(lambda: threefry.init_normals_reference(init_keys, counts, factors, zeros),
                       reps=5, rounds=3)
    floor = kernels.launcher("random_normal_floor")
    c_counts, _ = threefry._layer_table(tuple(counts), tuple(factors))
    floor_ms = graph_ms(lambda: kernels.check("random_normal_floor", floor(
        p, len(counts), c_counts, zeros, kernels.stream_handle(dev))))
    nbytes, f32_ops, int_ops = init_ops(p, dims)
    b_ms, by = bound(nbytes, f32_ops, int_ops)
    from distributed_drift_detection_tpu_torch.kernels import _build

    sass = sass_hash_ops(str(_build.library_path("random_normal")), "init_normals_kernel")
    print(f"K8 random_normal, the whole init [{p} keys x {counts} normals + {zeros} zeros]: "
          f"{ms:.5f} ms device (graph of 50), {h_us:.1f} us host a mlp_init call, "
          f"{plain_ms:.4f} ms plain, bound {b_ms:.5f} ms ({by}: {int_ops:,} integer operations "
          f"at {INT32_OPS_PER_S / 1e12:.2f} T/s), floor {floor_ms:.5f} ms (an empty kernel with "
          f"its grid); SASS {sass}")
    return dict(
        name="random_normal", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/random_normal.cu",
        replaces="distributed_drift_detection_tpu/models/classifiers.py:266",
        max_abs_err=0.0, ms=ms, host_us=h_us, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=by, library_ms=None, floor_ms=floor_ms, sass=sass,
    )


def k9_inputs(rng, base_X, base_y, p, b, c):
    """A training batch per partition of random rows (labels mod C), {0, 1}
    weights, partition 1 all invalid: numpy arrays."""
    idx = rng.integers(0, len(base_y), (p, b))
    X = base_X[idx].astype(np.float32)
    y = (base_y[idx] % c).astype(np.int32)
    w = (rng.random((p, b)) < 0.95).astype(np.float32)
    if p > 1:
        w[1] = 0.0
    return X, y, w


def check_k9_close(torch, mlp, keys, batch, dims, steps, lr, what):
    """K9 and its plain version after at most ``K9_TIGHT_STEPS`` steps, to
    ``K9_RTOL`` / ``K9_TIGHT_ATOL`` on every parameter."""
    short = min(steps, K9_TIGHT_STEPS)
    got = mlp.mlp_fit(keys, *batch, dims, short, lr)
    want = mlp.mlp_fit_reference(keys, *batch, dims, short, lr, 0.9)
    ok = all(torch.allclose(g, r, rtol=K9_RTOL, atol=K9_TIGHT_ATOL)
             for gl, rl in zip(got, want) for g, r in zip(gl, rl))
    check(ok, f"K9 differs from its plain version after {short} steps ({what})")


def fit_gap(torch, got, want):
    return max(float((g.cpu() - r.cpu()).abs().max()) for gl, rl in zip(got, want)
               for g, r in zip(gl, rl))


def check_k9(torch, kernels, mlp, prep, dev):
    """K9 against its plain version within ``K9_ATOL`` on the main path's
    first training batch with its fit keys, on random rows and on the edge
    cases, and bit for bit against the init with no step; bit for bit
    against the one-CTA kernel (the pinned digests) on the main path's batch and
    the F = 27 batch, at every cluster size; times it on the main path's
    batch at the launcher's cluster size and at each; returns its kernel row
    and the fitted params."""
    cfg, stream = prep.config, prep.stream
    dims = mlp_dims(stream, cfg)
    steps, lr = cfg.fit_steps, cfg.mlp_learning_rate
    _, fit_keys = mlp_keys(torch, prep, dev)
    rng = np.random.default_rng(9)
    p, b = cfg.partitions, cfg.per_batch
    main = [torch.from_numpy(a).to(dev) for a in k7_main_batch(prep.batches)]
    rand = [torch.from_numpy(a).to(dev) for a in k9_inputs(rng, stream.base_X, stream.base_y,
                                                          p, b, stream.num_classes)]
    gaps = {}
    for what, batch in (("main path", main), ("random rows", rand)):
        check_k9_close(torch, mlp, fit_keys, batch, dims, steps, lr, what)
        got = mlp.mlp_fit(fit_keys, *batch, dims, steps, lr)
        want = mlp.mlp_fit_reference(fit_keys, *batch, dims, steps, lr, 0.9)
        torch.cuda.synchronize()
        gaps[what] = fit_gap(torch, got, want)
        check(gaps[what] <= K9_ATOL, f"K9 differs from its plain version by {gaps[what]} ({what})")
        if what == "main path":
            main_params = got
    init = mlp.mlp_init(fit_keys, dims)
    zero = mlp.mlp_fit(fit_keys, *main, dims, 0, lr)
    check(all(torch.equal(z.w.view(torch.int32), i.w.view(torch.int32)) for z, i in zip(zero, init)),
          "K9's init differs from the plain init (no step)")
    for ep, eb, ef, ec, hidden, esteps in K9_EDGES:
        edims = (ef, *hidden, ec)
        protos = rng.normal(size=(ec, ef)).astype(np.float32) * 2
        ey = rng.integers(0, ec, (ep, eb)).astype(np.int32)
        eX = (protos[ey] + 0.5 * rng.normal(size=(ep, eb, ef))).astype(np.float32)
        ew = (rng.random((ep, eb)) < 0.9).astype(np.float32)
        ew[0, ::3] = 0.0
        ekeys = fit_keys[:ep].contiguous()
        batch = [torch.from_numpy(a).to(dev) for a in (eX, ey, ew)]
        check_k9_close(torch, mlp, ekeys, batch, edims, esteps, lr, f"P={ep} B={eb}")
        got = mlp.mlp_fit(ekeys, *batch, edims, esteps, lr)
        want = mlp.mlp_fit_reference(ekeys, *batch, edims, esteps, lr, 0.9)
        gap = fit_gap(torch, got, want)
        check(gap <= K9_ATOL, f"K9 differs from its plain version by {gap} "
              f"(P={ep} B={eb} F={ef} C={ec} {hidden})")
        gaps[f"P={ep} B={eb} F={ef} C={ec} {hidden} {esteps} steps"] = gap
    print(f"K9 mlp_fit: within rtol {K9_RTOL} / atol {K9_TIGHT_ATOL} of its plain version "
          f"after {K9_TIGHT_STEPS} steps, and within {K9_ATOL} after all (max abs gap: "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + "); the init bit for bit with no step")

    ctas, _ = mlp.k9_launch_plan(main[0].device, dims, b, p)
    check(params_digest(main_params) == K9_MAIN_DIGEST,
          "K9 differs from the one-CTA kernel on the main path's batch (digest)")
    fp, _, ff, fc, fhidden, fsteps = K9_F27
    f27 = [torch.from_numpy(a).to(dev) for a in k9_f27_batch()]
    check(params_digest(mlp.mlp_fit(fit_keys[:fp].contiguous(), *f27, (ff, *fhidden, fc),
                                     fsteps, lr)) == K9_F27_DIGEST,
          "K9 differs from the one-CTA kernel on the F = 27 batch (digest)")
    fn = kernels.launcher("mlp_fit")
    by_cluster = {}
    for size in mlp.K9_CTAS:
        got = tuple(mlp.MLPLayer(torch.empty_like(l.w), torch.empty_like(l.b))
                    for l in main_params)
        sargs, skeep = mlp.mlp_fit_args(fit_keys, *main, dims, steps, lr, 0.9, got, None, size)
        kernels.check("mlp_fit", fn(*sargs, kernels.stream_handle(dev)))
        torch.cuda.synchronize()
        check(params_digest(got) == K9_MAIN_DIGEST,
              f"K9 with {size} CTAs a partition differs from the one-CTA kernel (digest)")
        by_cluster[size] = graph_ms(lambda: kernels.check(
            "mlp_fit", fn(*sargs, kernels.stream_handle(dev))), reps=10, rounds=3)
        del skeep
    print(f"K9 mlp_fit: bit for bit the one-CTA kernel (pinned digests: the main path's batch at "
          f"every cluster size, the F = 27 batch); {ctas} CTAs a partition chosen; device ms "
          "by CTAs a partition (graph of 10): "
          + ", ".join(f"{k}: {v:.5f}" for k, v in by_cluster.items()))

    out = tuple(mlp.MLPLayer(torch.empty_like(l.w), torch.empty_like(l.b)) for l in main_params)
    args, keep = mlp.mlp_fit_args(fit_keys, *main, dims, steps, lr, 0.9, out, None, ctas)
    ms = graph_ms(lambda: kernels.check("mlp_fit", fn(*args, kernels.stream_handle(dev))),
                  reps=10, rounds=3)
    h_us = host_us(lambda: mlp.mlp_fit(fit_keys, *main, dims, steps, lr), calls=20, rounds=3)
    plain_ms = time_ms(lambda: mlp.mlp_fit_reference(fit_keys, *main, dims, steps, lr, 0.9),
                       reps=3, rounds=3)
    dim_arr = keep[0]
    floor = kernels.launcher("mlp_fit_floor")
    floor_ms = graph_ms(lambda: kernels.check("mlp_fit_floor", floor(
        p, b, len(dims) - 1, ctypes.addressof(dim_arr), ctas, kernels.stream_handle(dev))))
    nparams = sum(l.w[0].numel() + l.b[0].numel() for l in main_params)
    b_ms, by = bound(p * b * (dims[0] + 2) * 4 + p * 8 + p * nparams * 4,
                     p * mlp_fit_ops(dims, b, steps))
    print(f"K9 mlp_fit [{p}, {b}] {dims} {steps} steps, {ctas} CTAs a partition: {ms:.5f} ms "
          f"device (graph of 10), {h_us:.1f} us host a call, {plain_ms:.4f} ms plain, bound "
          f"{b_ms:.5f} ms ({by}), floor {floor_ms:.5f} ms (an empty kernel with its grid, "
          "cluster, block and shared memory)")
    del keep
    return dict(
        name="mlp_fit", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/mlp_fit.cu",
        replaces="distributed_drift_detection_tpu/models/classifiers.py:286",
        max_abs_err=max(gaps.values()), ms=ms, host_us=h_us, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=by, library_ms=None, floor_ms=floor_ms,
        cluster_ctas=ctas, ms_by_cluster=by_cluster,
    ), main_params


def logit_near_ties(torch, params, rows):
    """Rows whose two best float64 logits lie within 1e-4·(1 + |top|) —
    inside the float32 rounding of three layers' sums."""
    h = rows.double()
    for layer in params[:-1]:
        h = torch.relu(torch.bmm(h, layer.w.double()) + layer.b.double()[:, None])
    logits = torch.bmm(h, params[-1].w.double()) + params[-1].b.double()[:, None]
    top2 = logits.topk(2, -1).values
    return (top2[..., 0] - top2[..., 1]) <= 1e-4 * (1 + top2[..., 0].abs())


# K10 is bit for bit the same at every plan (tile, rows a CTA, CTAs a
# partition, weight path): the SHA-256 of its predictions and errors
# (``k10_digest``) that the one-output-a-thread kernel of commit b2a30dd
# (unchanged through cbca321) gives at the main path's shape
# (``k10_main_inputs``) with the main path's first fitted params (K9's,
# pinned by K9_MAIN_DIGEST), and on the ragged case ``k10_f27_case``
# (F = 27, C = 5, int32 indices) (NVIDIA H100 80GB HBM3; chip_kernel_ab.py
# against cbca321).
K10_MAIN_DIGEST = "69d959effb4abe4d5284f4f0ee3712296ebbb9c09be0c47acfae505917f579e1"
K10_F27_DIGEST = "286950d9f4ede00a4ab9163edd4701fd6ae6bddd832197d4b588490e750d5f9a"
# the ragged case's shape (P, N, F, C, hidden); its data is k10_f27_case's
K10_F27 = (3, 1000, 27, 5, (128, 64))
# K10's nets beyond the main path's, (P, N, F, C, hidden, idx dtype): the
# ragged case; narrow widths; the nets of ROADMAP C5 — (256, 128) and
# (512,) stream their weights, no hidden layer, nine layers; a layer too
# wide for shared memory (the global workspace).
K10_EDGES = [(3, 1000, 27, 5, (128, 64), np.int32), (4, 333, 21, 40, (16, 8), np.int16),
             (4, 2000, 21, 40, (256, 128), np.int16), (4, 2000, 21, 40, (512,), np.int16),
             (3, 777, 21, 40, (), np.int32), (2, 500, 21, 40, (32,) * 8, np.int16),
             (2, 300, 21, 40, (4096,), np.int16)]


def k10_digest(pred, err) -> str:
    """SHA-256 of K10's predictions (int32) and errors (f32), in that order."""
    h = hashlib.sha256()
    for t in (pred, err):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def k10_main_inputs(stream, p, n):
    """The row table, its labels and a random int16 gather index [p, n]
    over it (seed 10): numpy arrays."""
    rng = np.random.default_rng(10)
    idx = rng.integers(0, len(stream.base_y), (p, n)).astype(np.int16)
    return stream.base_X, stream.base_y.astype(np.int32), idx


def k10_case(torch, mlp, dev, p, n, f, c, hidden, dt, seed):
    """A K10 case from numpy alone (seed ``seed``): params drawn at the
    init's scale with small biases, a table of 3,000 rows around C
    prototypes pushed through the first layer's shape, its labels and a
    gather index of dtype ``dt`` — as tensors on ``dev``."""
    rng = np.random.default_rng(seed)
    dims = (f, *hidden, c)
    params = tuple(
        mlp.MLPLayer(torch.from_numpy((rng.normal(size=(p, a, b)) * np.sqrt(2.0 / a))
                                      .astype(np.float32)).to(dev),
                     torch.from_numpy((0.1 * rng.normal(size=(p, b))).astype(np.float32)).to(dev))
        for a, b in zip(dims[:-1], dims[1:]))
    protos = rng.normal(size=(c, f)).astype(np.float32) * 2
    T = (protos[rng.integers(0, c, 3000)] + 0.7 * rng.normal(size=(3000, f))).astype(np.float32)
    Ty = rng.integers(0, c, 3000).astype(np.int32)
    idx = rng.integers(0, 3000, (p, n)).astype(dt)
    return params, *(torch.from_numpy(a).to(dev) for a in (T, Ty, idx))


def k10_f27_case(torch, mlp, dev):
    p, n, f, c, hidden = K10_F27
    return k10_case(torch, mlp, dev, p, n, f, c, hidden, np.int32, 27)


def k10_plan_text(plan) -> str:
    return (f"{plan.rows} rows a tile, {plan.threads} threads, {plan.ctas} CTAs a partition, "
            f"weights {'streamed' if plan.stream else 'resident'}, "
            + (f"global workspace {plan.global_words} floats a CTA" if plan.global_
               else "no global workspace")
            + f", {plan.shared_bytes} B shared")


def check_k10_equal(torch, mlp, params, T, Ty, idx, what):
    err, pred = mlp.mlp_predict_err(params, T, Ty, idx, return_pred=True)
    rerr, rpred = mlp.mlp_predict_err_reference(params, T, Ty, idx)
    torch.cuda.synchronize()
    tie = logit_near_ties(torch, params, T[idx.long()][..., :params[0].w.shape[1]])
    check(torch.equal(pred[~tie], rpred[~tie]),
          f"K10 predictions differ from its plain version off the near ties ({what})")
    check(torch.equal(err, (pred != Ty[idx.long()]).float()), f"K10 errors are not pred != y ({what})")
    return int(tie.sum()), int((pred != rpred).sum())


def k10_launch(torch, kernels, mlp, params, T, Ty, idx, force):
    """K10 through its launcher at the forced plan fields ``force``
    (uncounted): (pred, err)."""
    dev = idx.device
    p, n = idx.shape
    dims = (params[0].w.shape[1], *(l.w.shape[2] for l in params))
    plan = mlp.k10_launch_plan(dev, dims, p, n, tuple(force))
    err = torch.empty((p, n), dtype=torch.float32, device=dev)
    pred = torch.empty((p, n), dtype=torch.int32, device=dev)
    args, keep = mlp.mlp_predict_err_args(params, mlp.pad_row_table(T), Ty, idx, err, pred,
                                          mlp.k10_scratch(plan, p, dev), mlp.k10_force(plan))
    kernels.check("mlp_predict_err", kernels.launcher("mlp_predict_err")(
        *args, kernels.stream_handle(dev)))
    torch.cuda.synchronize()
    del keep
    return pred, err


# K10's plans timed beside the chosen one, (label, forced fields (rows,
# threads, CTAs a partition, stream)): one tile a CTA (CTAs 10**6, cut to
# the tiles) at 64 and 128 rows and 128 and 256 threads; persistent CTAs at
# the same; the weights streamed.
K10_VARIANTS = [
    ("tile a CTA, 64 rows, 128 thr", (64, 128, 10**6, 0)),
    ("tile a CTA, 64 rows, 256 thr", (64, 256, 10**6, 0)),
    ("tile a CTA, 128 rows, 128 thr", (128, 128, 10**6, 0)),
    ("tile a CTA, 128 rows, 256 thr", (128, 256, 10**6, 0)),
    ("persistent, 64 rows, 128 thr", (64, 128, 0, 0)),
    ("persistent, 64 rows, 256 thr", (64, 256, 0, 0)),
    ("persistent, 128 rows, 128 thr", (128, 128, 0, 0)),
    ("persistent, 128 rows, 256 thr", (128, 256, 0, 0)),
    ("persistent, 128 rows, 256 thr, streamed", (128, 256, 0, 1)),
    ("persistent, 64 rows, 256 thr, streamed", (64, 256, 0, 1)),
]


def check_k10(torch, kernels, mlp, prep, params, dev):
    """K10 bit for bit the kernel it replaced (the pinned digests) at the main
    path's shape with the main path's first fitted params and on the
    F = 27 case, at its plan and at every variant of ``K10_VARIANTS``
    (both weight paths among them); against its plain version — equal
    predictions off the near ties — there and on ``K10_EDGES``, each with
    its plan printed; times the chosen plan and each variant; returns its
    kernel row."""
    cfg, stream = prep.config, prep.stream
    dims = mlp_dims(stream, cfg)
    p, n = cfg.partitions, cfg.window * cfg.per_batch
    T, Ty, idx = (torch.from_numpy(a).to(dev) for a in k10_main_inputs(stream, p, n))
    ties, differ = check_k10_equal(torch, mlp, params, T, Ty, idx, "main path")
    err, pred = mlp.mlp_predict_err(params, T, Ty, idx, return_pred=True)
    check(k10_digest(pred, err) == K10_MAIN_DIGEST,
          "K10 differs from the kernel it replaced at the main path's shape (digest)")
    fcase = k10_f27_case(torch, mlp, dev)
    ferr, fpred = mlp.mlp_predict_err(*fcase, return_pred=True)
    check(k10_digest(fpred, ferr) == K10_F27_DIGEST,
          "K10 differs from the kernel it replaced on the F = 27 case (digest)")
    max_err = float((err - mlp.mlp_predict_err_reference(params, T, Ty, idx)[0]).abs().max())
    plan = mlp.k10_launch_plan(dev, dims, p, n)
    print(f"K10 mlp_predict_err: bit for bit the kernel it replaced (pinned digests at the main path's "
          f"shape and the F = 27 case); main path plan: {k10_plan_text(plan)}")
    notes = [f"main path {ties} near ties, {differ} predictions differ"]
    for k, (ep, en, ef, ec, hidden, dt) in enumerate(K10_EDGES):
        case = k10_case(torch, mlp, dev, ep, en, ef, ec, hidden, dt, 100 + k)
        edims = (ef, *hidden, ec)
        what = f"P={ep} N={en} F={ef} C={ec} {hidden} {np.dtype(dt).name}"
        t, d = check_k10_equal(torch, mlp, *case, what)
        eplan = mlp.k10_launch_plan(dev, edims, ep, en)
        print(f"K10 {what}: {t} near ties, {d} differ; plan: {k10_plan_text(eplan)}")
        notes.append(f"{what}: {t} near ties")
    print("K10 mlp_predict_err: predictions equal to its plain version off the near ties "
          "(two best float64 logits within 1e-4·(1 + |top|)), errors = pred != y; "
          + "; ".join(notes))

    Tp = mlp.pad_row_table(T)
    fn = kernels.launcher("mlp_predict_err")
    by_plan = {}
    for label, force in [("chosen", mlp.k10_force(plan))] + K10_VARIANTS:
        vplan = mlp.k10_launch_plan(dev, dims, p, n, tuple(force))
        vpred, verr = k10_launch(torch, kernels, mlp, params, T, Ty, idx, force)
        check(torch.equal(vpred, pred) and torch.equal(verr.view(torch.int32), err.view(torch.int32)),
              f"K10's plan {label} ({k10_plan_text(vplan)}) differs from its chosen plan")
        fpred2, ferr2 = k10_launch(torch, kernels, mlp, *fcase, force)
        check(k10_digest(fpred2, ferr2) == K10_F27_DIGEST,
              f"K10's plan {label} differs from the kernel it replaced on the F = 27 case (digest)")
        out = torch.empty((p, n), dtype=torch.float32, device=dev)
        vargs, vkeep = mlp.mlp_predict_err_args(params, Tp, Ty, idx, out, None, None,
                                                mlp.k10_force(vplan))
        by_plan[label] = graph_ms(lambda: kernels.check(
            "mlp_predict_err", fn(*vargs, kernels.stream_handle(dev))), reps=10, rounds=3)
        del vkeep
    print("K10 mlp_predict_err: every plan bit for bit the chosen one (both weight paths "
          "among them); device ms by plan (graph of 10): "
          + ", ".join(f"{k}: {v:.5f}" for k, v in by_plan.items()))

    err_buf = torch.empty((p, n), dtype=torch.float32, device=dev)
    args, keep = mlp.mlp_predict_err_args(params, Tp, Ty, idx, err_buf, None, None,
                                          mlp.k10_force(plan))
    ms = graph_ms(lambda: kernels.check("mlp_predict_err", fn(*args, kernels.stream_handle(dev))),
                  reps=10, rounds=3)
    h_us = host_us(lambda: mlp.mlp_predict_err(params, Tp, Ty, idx))
    plain_ms = time_ms(lambda: mlp.mlp_predict_err_reference(params, Tp, Ty, idx), reps=5, rounds=3)
    lib_ms = k10_library_ms(torch, params, Tp, idx, dims[0])
    floor = kernels.launcher("mlp_predict_err_floor")
    floor_ms = graph_ms(lambda: kernels.check("mlp_predict_err_floor", floor(
        p, n, len(dims) - 1, ctypes.addressof(keep[0]), *mlp.k10_force(plan),
        kernels.stream_handle(dev))))
    macs = sum(a * c for a, c in zip(dims[:-1], dims[1:]))
    nparams = sum(l.w[0].numel() + l.b[0].numel() for l in params)
    # idx i16 + err f32 per row, the row table and labels, the params
    nbytes = p * n * 6 + T.numel() * 4 + Ty.numel() * 4 + p * nparams * 4
    b_ms, by = bound(nbytes, p * n * 2 * macs)
    print(f"K10 mlp_predict_err [{p}, {n}] {dims}: {ms:.5f} ms device (graph of 10), "
          f"{h_us:.1f} us host a call, {plain_ms:.4f} ms plain, bound {b_ms:.5f} ms ({by}), "
          f"library {lib_ms:.5f} ms (the products only, not the fused function: the layers' "
          f"torch.bmm on the gathered rows, TF32 off, graph of 10), floor {floor_ms:.5f} ms "
          "(an empty kernel with its grid, block and shared memory)")
    del keep
    return dict(
        name="mlp_predict_err", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/mlp_predict_err.cu",
        replaces="distributed_drift_detection_tpu/models/classifiers.py:302",
        max_abs_err=max_err, ms=ms, host_us=h_us, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=by, library_ms=lib_ms, floor_ms=floor_ms,
        plan=mlp.k10_force(plan), ms_by_plan=by_plan,
    )


def k10_library_ms(torch, params, Tp, idx, f):
    """K10's yardstick: the layers' ``torch.bmm`` products alone (biases,
    ReLU, the argmax and the gather left out) on the gathered rows, TF32
    off, timed as ``ms`` is (graph of 10)."""
    rows = Tp[idx.long(), :f].contiguous()
    outs = [torch.empty((rows.shape[0], rows.shape[1], l.w.shape[2]), device=rows.device)
            for l in params]
    torch.backends.cuda.matmul.allow_tf32 = False

    def products():
        h = rows
        for l, o in zip(params, outs):
            torch.bmm(h, l.w, out=o)
            h = o

    return graph_ms(products, reps=10, rounds=3)


# --------------------------------------------------------------------------
# the oblique forest's kernels: K11 forest_fit, K12 forest_predict_err
# --------------------------------------------------------------------------

# The JAX package's run of SMOKE with model='forest' (32 trees of depth 3,
# W = 128, R = 4, the retrain guard 0.3): (detections, mean delay in rows).
# Its projections cannot match XLA's dot to the bit (ROADMAP C6), so the
# bar is equal detections and a mean delay within a batch.
FOREST_EXPECTED = (624, 788.6282)
# K11 and K12 edge cases (P, B, F, C, trees, depth, what): all weights
# 0, B = 1, depth 1 and 8, one tree, C = 70 (above 64), int32 indices, B =
# 300, the rialto width, and K12's layouts past the register kernel: rows
# read from the table, projections read from device memory, both; T = 500
# (16-bit counters); trees across a warp's boundary (T = 33, 64); a column
# select past one lane's registers (B = 1,500, with repeated rows); K12's
# counters in device memory (C = 2,000, T = 40); a register width with a
# full last float4 (F = 40); K11's deep-tree layout (depth 12, T = 2: the
# columns read from device memory, the keys in chunks, the row rule); and
# repeated rows, so that equal keys test the stable order.
FOREST_EDGES = [(3, 100, 21, 40, 32, 3, "weights 0"), (4, 1, 21, 40, 8, 3, "B=1"),
                (2, 50, 5, 3, 3, 1, "depth 1"), (2, 100, 21, 70, 1, 8, "depth 8, C=70"),
                (2, 30, 7, 4, 1, 3, "one tree"), (3, 100, 21, 40, 32, 3, "int32 idx"),
                (2, 300, 21, 40, 32, 3, "B=300"), (3, 64, 27, 10, 4, 2, "rialto width"),
                (2, 60, 600, 5, 4, 2, "rows from the table"),
                (2, 100, 300, 10, 32, 3, "projections from device memory"),
                (2, 100, 2048, 10, 32, 3, "F=2048: rows and projections from device memory"),
                (2, 50, 21, 40, 500, 1, "T=500: 16-bit counters"),
                (2, 100, 21, 40, 33, 3, "T=33"), (2, 100, 21, 40, 64, 3, "T=64"),
                (2, 1500, 21, 40, 8, 3, "B=1500, repeated rows"),
                (2, 100, 21, 2000, 40, 3, "C=2000, T=40: counters in device memory"),
                (2, 100, 40, 10, 32, 3, "F=40"),
                (2, 100, 21, 40, 2, 12, "depth 12, T=2"),
                (2, 120, 21, 6, 16, 3, "repeated rows")]


def forest_edge_batch(rng, ep, eb, ef, ec, what):
    """An edge case's training batch ``(X, y, w)``: rows near ``ec``
    prototypes, 90 % valid; rows repeated in runs when ``what`` says so."""
    protos = rng.normal(size=(ec, ef)).astype(np.float32) * 2
    ey = rng.integers(0, ec, (ep, eb)).astype(np.int32)
    eX = (protos[ey] + 0.5 * rng.normal(size=(ep, eb, ef))).astype(np.float32)
    ew = (rng.random((ep, eb)) < 0.9).astype(np.float32)
    if what == "weights 0":
        ew[:] = 0.0
    if "repeated rows" in what:  # each run of 5 rows one row, one label
        src = np.arange(eb) // 5 * 5
        eX, ey = eX[:, src], ey[:, src]
    return protos, eX, ey, ew


def forest_equal(torch, forest, params, T, Ty, idx, c, what, force=0):
    """K12 on ``params`` equal to its plain version bit for bit."""
    err, pred = forest.forest_predict_err(params, T, Ty, idx, return_pred=True, classes=c,
                                          force=force)
    rerr, rpred = forest.forest_predict_err_reference(params, T, Ty, idx)
    torch.cuda.synchronize()
    check(torch.equal(pred, rpred) and torch.equal(err, rerr),
          f"K12 differs from its plain version ({what})")


def forest_fit_equal(torch, forest, key, X, y, w, trees, depth, c, what, force=0):
    """K11 equal to its plain version bit for bit; returns K11's params."""
    got = forest.forest_fit(key, X, y, w, trees, depth, c, force=force)
    want = forest.forest_fit_reference(key, X, y, w, trees, depth, c)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        check(torch.equal(g, r), f"K11 differs from its plain version ({what})")
    return got


def k12_library_ms(torch, params, Tp, idx, f):
    """K12's yardstick: ``torch.bmm`` of the gathered rows by the
    projections of all T·n nodes, TF32 off — the products of every node,
    more than K12 computes and nothing else of its work — timed as ``ms``
    is (graph of 10)."""
    rows = Tp[idx.long(), :f].contiguous()
    out = torch.empty((rows.shape[0], rows.shape[1], params.proj.shape[2]), device=rows.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    return graph_ms(lambda: torch.bmm(rows, params.proj, out=out), reps=10, rounds=3)


def forest_fit_ops(b, f, trees, depth):
    """f32 operations one partition's fit needs, whatever its algorithm
    (the draws' integer hashes are :func:`forest_fit_int_ops`): erf_inv's
    ≈ 40 a normal, z's
    product and add a (row, node, feature), a selection of ⌈log2 B⌉
    compares a (row, node) — what a sort of each column takes — the
    routing's compare a (row, tree, level), and an add a (row, tree) for
    the leaf counts and a row for the batch's class counts."""
    tn = trees * ((1 << depth) - 1)
    return (40 * f * tn + 2 * b * tn * f + b * math.ceil(math.log2(b)) * tn
            + b * trees * depth + b * trees + b)


def forest_fit_int_ops(f, trees, depth):
    """32-bit integer operations of one partition's draws: a threefry hash
    (``HASH_INT_OPS``) for each of the F·T·n normals and T·n uniforms, and
    the two of ``split(key, 2)``."""
    tn = trees * ((1 << depth) - 1)
    return HASH_INT_OPS * (f * tn + tn + 2)


def check_k11_k12(torch, kernels, forest, prep, dev):
    """K11 and K12 against their plain versions bit for bit: K11 on the
    main path's first training batch with its fit keys, on random rows and
    on ``FOREST_EDGES``; K12 on K11's params at the main path's shape
    [16, 12,800] and on the edges; times both as K7 is timed; returns
    their kernel rows."""
    cfg, stream = prep.config, prep.stream
    trees, depth, c, f = cfg.forest_trees, cfg.forest_depth, stream.num_classes, stream.num_features
    p, b, n = cfg.partitions, cfg.per_batch, cfg.window * cfg.per_batch
    _, fit_keys = mlp_keys(torch, prep, dev)
    main = [torch.from_numpy(a).to(dev) for a in k7_main_batch(prep.batches)]
    rng = np.random.default_rng(11)
    params = forest_fit_equal(torch, forest, fit_keys, *main, trees, depth, c, "main path")
    rand = [torch.from_numpy(a).to(dev) for a in k7_inputs(rng, stream.base_X, stream.base_y,
                                                          p, b, c)]
    forest_fit_equal(torch, forest, fit_keys, *rand, trees, depth, c, "random rows")
    T, Ty, idx = (torch.from_numpy(a).to(dev) for a in k10_main_inputs(stream, p, n))
    Tp = forest.pad_row_table(T)
    forest_equal(torch, forest, params, Tp, Ty, idx, c, "main path")
    for ep, eb, ef, ec, et, ed, what in FOREST_EDGES:
        protos, *batch = forest_edge_batch(rng, ep, eb, ef, ec, what)
        batch = [torch.from_numpy(a).to(dev) for a in batch]
        eparams = forest_fit_equal(torch, forest, fit_keys[:ep].contiguous(), *batch, et, ed,
                                   ec, what)
        eT = (protos[rng.integers(0, ec, 900)] + 0.7 * rng.normal(size=(900, ef))).astype(np.float32)
        eTy = rng.integers(0, ec, 900).astype(np.int32)
        eidx = rng.integers(0, 900, (ep, 777)).astype(np.int32 if what == "int32 idx" else np.int16)
        forest_equal(torch, forest, eparams, *(torch.from_numpy(a).to(dev) for a in (eT, eTy, eidx)),
                     ec, what)
    print(f"K11 forest_fit and K12 forest_predict_err: bitwise equal to their plain versions on "
          f"the main path's first batch [{p}, {b}] F={f} C={c} T={trees} depth {depth} with its "
          f"fit keys (K12 at [{p}, {n}]), on random rows, and at "
          + ", ".join(f"{w} (P={a} B={bb} F={ff} C={cc} T={tt} depth {dd})"
                      for a, bb, ff, cc, tt, dd, w in FOREST_EDGES))

    fit_fn, pred_fn = kernels.launcher("forest_fit"), kernels.launcher("forest_predict_err")
    out = forest.ForestParams(*(torch.empty_like(t) for t in params))
    scratch = forest.forest_fit_scratch(p, b, f, c, trees, depth, dev)
    fargs = forest.forest_fit_args(fit_keys, *main, trees, depth, c, out, scratch)
    fit_ms = graph_ms(lambda: kernels.check("forest_fit", fit_fn(*fargs, kernels.stream_handle(dev))))
    fit_host = host_us(lambda: forest.forest_fit(fit_keys, *main, trees, depth, c))
    fit_plain = time_ms(lambda: forest.forest_fit_reference(fit_keys, *main, trees, depth, c),
                        reps=3, rounds=3)
    floor = kernels.launcher("forest_fit_floor")
    fit_floor = graph_ms(lambda: kernels.check("forest_fit_floor", floor(
        p, b, f, c, trees, depth, kernels.stream_handle(dev))))
    tn = trees * ((1 << depth) - 1)
    # X, y, w and the keys read once; proj, thresh and leaf_class written
    # once; the f32 work, and the draws' hashes at the integer rate
    fit_int = p * forest_fit_int_ops(f, trees, depth)
    fb_ms, fby = bound(p * b * (f + 2) * 4 + p * 8 + p * (f * tn + tn + trees * (1 << depth)) * 4,
                       p * forest_fit_ops(b, f, trees, depth), fit_int)
    fplan = forest.k11_plan(b, f, c, trees, depth)
    print(f"K11 forest_fit [{p}, {b}] F={f} C={c} T={trees} depth {depth}: {fit_ms:.5f} ms "
          f"device (graph of 50), {fit_host:.1f} us host a call, {fit_plain:.4f} ms plain, "
          f"bound {fb_ms:.5f} ms ({fby}; {fit_int:,} integer operations at "
          f"{INT32_OPS_PER_S / 1e12:.2f} T/s), floor {fit_floor:.5f} ms (an empty kernel with its "
          f"grid, block and shared memory); {p * trees} CTAs, layout {fplan._asdict()}")

    err = torch.empty((p, n), dtype=torch.float32, device=dev)
    work = forest.k12_workspace(p, n, f, trees, depth, c, dev)
    pargs = forest.forest_predict_err_args(params, Tp, Ty, idx, c, err, None, work)
    pred_ms = graph_ms(lambda: kernels.check("forest_predict_err",
                                             pred_fn(*pargs, kernels.stream_handle(dev))),
                       reps=10, rounds=3)
    pred_host = host_us(lambda: forest.forest_predict_err(params, Tp, Ty, idx, classes=c))
    pred_plain = time_ms(lambda: forest.forest_predict_err_reference(params, Tp, Ty, idx),
                         reps=3, rounds=3)
    pfloor = kernels.launcher("forest_predict_err_floor")
    pred_floor = graph_ms(lambda: kernels.check("forest_predict_err_floor", pfloor(
        p, n, f, trees, depth, c, kernels.stream_handle(dev))))
    pred_lib = k12_library_ms(torch, params, Tp, idx, f)
    # idx i16 + err f32 a row, the row table and labels, the params read
    # once; a product and an add a (row, visited node, feature), and a
    # tally of the T votes a row
    pb_ms, pby = bound(p * n * 6 + Tp.numel() * 4 + Ty.numel() * 4
                       + p * (f * tn + tn + trees * (1 << depth)) * 4,
                       p * n * (2 * trees * depth * f + trees))
    pplan = forest.k12_plan(dev, p, n, f, trees, depth, c)
    print(f"K12 forest_predict_err [{p}, {n}] F={f} T={trees} depth {depth}: {pred_ms:.5f} ms "
          f"device (graph of 10), {pred_host:.1f} us host a call, {pred_plain:.4f} ms plain, "
          f"bound {pb_ms:.5f} ms ({pby}), floor {pred_floor:.5f} ms (an empty kernel with its "
          f"grid, block and shared memory), library {pred_lib:.5f} ms (torch.bmm of the "
          f"gathered rows by all {tn} nodes' projections, TF32 off: the products only); "
          f"plan {pplan._asdict()}")
    rows = [
        dict(name="forest_fit", route="cuda",
             source="distributed_drift_detection_tpu_torch/csrc/forest_fit.cu",
             replaces="distributed_drift_detection_tpu/models/classifiers.py:391",
             max_abs_err=0.0, ms=fit_ms, host_us=fit_host, plain_ms=fit_plain,
             bound_ms=fb_ms, bound_by=fby, library_ms=None, floor_ms=fit_floor,
             plan=fplan._asdict()),
        dict(name="forest_predict_err", route="cuda",
             source="distributed_drift_detection_tpu_torch/csrc/forest_predict_err.cu",
             replaces="distributed_drift_detection_tpu/models/classifiers.py:431",
             max_abs_err=0.0, ms=pred_ms, host_us=pred_host, plain_ms=pred_plain,
             bound_ms=pb_ms, bound_by=pby, library_ms=pred_lib, floor_ms=pred_floor,
             plan=pplan._asdict()),
    ]
    return rows


# --------------------------------------------------------------------------
# CSV ingest, wide rows and the deep mlp
# --------------------------------------------------------------------------

# The JAX package's runs of SMOKE's CSV twin with data row 100's 4th field
# NaN and data row 2500 ragged (its last two fields dropped), on the CPU:
# (detections, mean delay in rows) under each policy.
DIRTY_EXPECTED = {"quarantine": (624, 960.0385), "repair": (624, 956.6538)}
# The wide-row run: a centroid stream of F = 2,048 written as a CSV, 8
# concepts of 100 rows at mult_data 64 (51,200 rows, SMOKE's partitions
# and per_batch): every partition finds its 7 planted boundaries.
WIDE_SPEC = "prototypes,seed=0,concepts=8,rows_per_concept=100,features=2048"
WIDE_MULT = 64
WIDE_EXPECTED = 16 * 7
# K2 at a width whose one class does not fit shared memory (its features
# in chunks): (P, N, C, F).
K2_FEATURE_CHUNKS = (2, 300, 5, 60000)
# The deep mlp: 64 hidden layers of 16 (65 layers, past the 64 a launch's
# parameters hold), at a small depth.
DEEP_HIDDEN = (16,) * 64
DEEP_MULT = 8
# Phase 15, the paper's experiment loop: the CLI's summary line on SMOKE's
# CSV twin (the JAX package's, up to final_time); the scaleup grid on that
# CSV (mults x partitions x trials, centroid + DDM); the parity models on
# the rialto stand-in (dataset, mult_data, partitions), one seed.
CLI_EXPECTED = "rows=2048000 detections=624 mean_delay_rows=788.6"
GRID_MULTS, GRID_PARTITIONS, GRID_TRIALS = (64, 128), (4, 16), 2
PARITY_MODELS = ("centroid", "gnb", "linear@robust", "mlp", "forest")
PARITY_FITTED = ("mlp", "forest")  # fits within rounding of the CPU's: a batch
PARITY_GEOMETRY = ("synth:rialto", 2.0, 4)
RF_SMALL = dict(dataset="synth:prototypes,seed=0,concepts=6,rows_per_concept=100,features=5",
                mult_data=3, partitions=4, per_batch=50, results_csv="", model="rf",
                rf_estimators=5)


def write_csv(spec: str, path: str, dirty: bool = False) -> None:
    """``spec``'s rows written in the reference's schema (``io/datasets.py``);
    with ``dirty``, data row 100's 4th field NaN and data row 2500 ragged."""
    from distributed_drift_detection_tpu_torch.io.datasets import _write_schema_csv
    from distributed_drift_detection_tpu_torch.io.synth import parse_synth

    _write_schema_csv(*parse_synth(spec), path)
    if dirty:
        with open(path) as fh:
            lines = fh.read().splitlines()
        fields = lines[101].split(",")
        fields[3] = "nan"
        lines[101] = ",".join(fields)
        lines[2501] = ",".join(lines[2501].split(",")[:-2])
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")


def wide_times(torch, kernels, classifiers, prep, dev) -> dict:
    """K7 on the wide run's first training batch (its features in chunks)
    and K2 at its predict's shape [P, W·B] (the generic path, its classes
    in chunks), each by graph replay, with its bound; printed and
    returned by name."""
    stream, cfg = prep.stream, prep.config
    p, b, c, f = cfg.partitions, cfg.per_batch, stream.num_classes, stream.num_features
    X, y, w = (torch.from_numpy(a).to(dev) for a in k7_main_batch(prep.batches))
    cent = torch.empty((p, c, f), dtype=torch.float32, device=dev)
    bias = torch.empty((p, c), dtype=torch.float32, device=dev)
    fit = kernels.launcher("centroid_fit")
    fargs = classifiers.centroid_fit_args(X, y, w, cent, bias)
    k7_ms = graph_ms(lambda: kernels.check("centroid_fit", fit(*fargs, kernels.stream_handle(dev))),
                     reps=10, rounds=3)
    k7_b, k7_by = bound(p * b * (f + 2) * 4 + p * c * (f + 1) * 4, p * b * (f + 1) + 2 * p * c * f)
    n = cfg.window * b  # K2 scores against the centroids K7's replays wrote
    T, Ty, idx = (torch.from_numpy(a).to(dev) for a in k10_main_inputs(stream, p, n))
    Tp = classifiers.pad_row_table(T)
    err = torch.empty((p, n), dtype=torch.float32, device=dev)
    pred = kernels.launcher("centroid_predict_err")
    pargs = classifiers.centroid_predict_err_args(cent, bias, Tp, Ty, idx, err)
    k2_ms = graph_ms(lambda: kernels.check("centroid_predict_err",
                                           pred(*pargs, kernels.stream_handle(dev))),
                     reps=10, rounds=3)
    k2_b, k2_by = bound(p * n * 6 + Tp.numel() * 4 + p * c * (f + 1) * 4, p * n * 2 * f * c)
    print(f"K7 centroid_fit at F={f} [{p}, {b}] C={c} (features in chunks): {k7_ms:.5f} ms "
          f"device (graph of 10), bound {k7_b:.5f} ms ({k7_by}); K2 centroid_predict_err at "
          f"F={f} [{p}, {n}] C={c}: {k2_ms:.5f} ms device (graph of 10), bound {k2_b:.5f} ms "
          f"({k2_by})")
    return {f"K7 F={f} [{p}, {b}] C={c}": k7_ms, f"K2 F={f} [{p}, {n}] C={c}": k2_ms}


def flags_equal(np_, a, b) -> bool:
    return all(np_.array_equal(getattr(a.flags, f), getattr(b.flags, f)) for f in a.flags._fields)



def threefry_keys(torch, p, dev):
    from distributed_drift_detection_tpu_torch.engine.loop import device_keys
    from distributed_drift_detection_tpu_torch.utils import threefry

    return device_keys(threefry.split(threefry.key(p), p), dev)


def wrappers():
    """Each kernel's counted wrapper, by kernel name."""
    from distributed_drift_detection_tpu_torch.engine import soak
    from distributed_drift_detection_tpu_torch.models import classifiers, forest, mlp
    from distributed_drift_detection_tpu_torch.ops import adwin, ddm, detectors, shuffle
    from distributed_drift_detection_tpu_torch.utils import threefry

    return {"ddm_window": ddm.ddm_window,
            "centroid_predict_err": classifiers.centroid_predict_err,
            "centroid_fit": classifiers.centroid_fit,
            "ph_window": detectors.ph_window,
            "eddm_window": detectors.eddm_window,
            "hddm_window": detectors.hddm_window,
            "hddm_w_window": detectors.hddm_w_window,
            "kswin_window": detectors.kswin_window,
            "stepd_window": detectors.stepd_window,
            "adwin_window": adwin.adwin_window,
            "random_normal": threefry.init_normals,
            "mlp_fit": mlp.mlp_fit,
            "mlp_predict_err": mlp.mlp_predict_err,
            "forest_fit": forest.forest_fit,
            "forest_predict_err": forest.forest_predict_err,
            "soak_batch": soak.soak_batch,
            "shuffle_perm": shuffle.shuffle_planes}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


def zoo_table(config):
    """Per zoo kernel: its JAX source line, plain version, init, parameter
    sets (the first timed) and element operations (for the bound)."""
    from distributed_drift_detection_tpu_torch.ops import adwin, detectors

    return {
        "ph_window": dict(
            replaces="distributed_drift_detection_tpu/ops/detectors.py:251",
            reference=detectors.ph_window_reference,
            init=lambda prm, p, dev: detectors.ph_init((p,), dev),
            params=[config.PHParams(threshold=32.0),
                    config.PHParams(min_num_instances=5, threshold=3.0, alpha=0.9),
                    config.PHParams(min_num_instances=3, delta=0.0, threshold=0.5, alpha=0.0)],
            # cumsum, mean (a division), 2 compose evaluations of 5 ops, the
            # final fma + max, 3 compares
            ops_per_element=18),
        "hddm_w_window": dict(
            replaces="distributed_drift_detection_tpu/ops/detectors.py:736",
            reference=detectors.hddm_w_window_reference,
            init=lambda prm, p, dev: detectors.hddm_w_init((p,), dev),
            params=[config.HDDMWParams(), config.HDDMWParams(lam=0.3)],
            # 2 trees x 2 compose evaluations of 6 ops, 2 final fma pairs,
            # 3 bounds (3 ops and a square root each), compares
            ops_per_element=50),
        "adwin_window": dict(
            replaces="distributed_drift_detection_tpu/ops/adwin.py:348",
            reference=adwin.adwin_window_reference,
            init=lambda prm, p, dev: adwin.adwin_init(prm, (p,), dev),
            params=[config.ADWINParams(), config.ADWINParams(clock=1),
                    config.ADWINParams(max_levels=3, clock=4)],
            ops_per_element=4),
        "eddm_window": dict(
            replaces="distributed_drift_detection_tpu/ops/detectors.py:382",
            reference=detectors.eddm_window_reference,
            init=lambda prm, p, dev: detectors.eddm_init((p,), dev),
            params=[config.EDDMParams(),
                    config.EDDMParams(paper_exact=True, min_num_errors=5)],
            # the count and error tests, d and d² (a conversion, a
            # product), two chain adds and the tree's, the two sums' carried
            # adds; at an event the moments (2 divisions, an fma, a square
            # root, 2 more) and the max and ratio tests
            ops_per_element=20),
        "hddm_window": dict(
            replaces="distributed_drift_detection_tpu/ops/detectors.py:548",
            reference=detectors.hddm_window_reference,
            init=lambda prm, p, dev: detectors.hddm_init((p,), dev),
            params=[config.HDDMParams(), config.HDDMParams(drift_confidence=0.01)],
            # the prefixes, the mean (a division), ε (a product, a
            # division, a square root), the key, the min, the cut's mean
            # (a division) and two bounds of 7 ops each, the compares
            ops_per_element=26),
        "kswin_window": dict(
            replaces="distributed_drift_detection_tpu/ops/detectors.py:973",
            reference=detectors.kswin_window_reference,
            init=lambda prm, p, dev: detectors.kswin_init(prm, (p,), dev),
            params=[config.KSWINParams(), config.KSWINParams(window_size=20, stat_size=5)],
            # the prefixes and the prefix row's write, 3 differences, 2
            # products, the gap's difference and abs, 2 compares
            ops_per_element=11),
        "stepd_window": dict(
            replaces="distributed_drift_detection_tpu/ops/detectors.py:1135",
            reference=detectors.stepd_window_reference,
            init=lambda prm, p, dev: detectors.stepd_init(prm, (p,), dev),
            params=[config.STEPDParams(), config.STEPDParams(window_size=5)],
            # the prefixes, the recent sum, the total, the z statistic (3
            # divisions, a square root, 11 more) and 4 compares
            ops_per_element=22),
    }


# K5 edge shapes (P, W, B): P = 1 and 17, W below a CTA's thread count,
# and rows of 26,000 and 16,000 elements whose scan levels overflow shared
# memory into the global scratch.
K5_EDGES = [(3, 7, 33), (1, 5, 30), (17, 4, 50), (2, 200, 130), (1, 160, 100)]
# and for the two paths of K5-ph, K5-hddm_w, K5-eddm and K5-hddm: the
# cluster path at P = 1 (7 CTAs), with clusters of one CTA at P = 80, a
# full cluster of 8 CTAs, batches that straddle CTAs; the one-CTA
# (global-scratch) path at P = 80 (with the 26,000-element rows above).
K5_CLUSTER_EDGES = [(1, 128, 100), (80, 3, 7), (80, 128, 100), (1, 128, 128), (3, 127, 129)]
CLUSTER_KERNELS = ("ph_window", "hddm_w_window", "eddm_window", "hddm_window", "kswin_window",
                   "stepd_window")
# and for K5-kswin and K5-stepd: rows shorter than their ring buffers (7, 20
# and 60 elements against 100 and 30, 20 and 5; k5_inputs' partition 1 is
# all padding), and a row of 60,000 elements whose prefix row leaves shared
# memory for the global scratch
K5_RING_EDGES = [(3, 1, 7), (6, 2, 10), (3, 60, 1), (2, 600, 100)]
RING_KERNELS = ("kswin_window", "stepd_window")
# and their look-backs across the CTAs of a cluster (7 at this shape):
# windows of 2,500 (KSWIN's stat_size 700) over rows whose second segment
# is padding (CTA 2's windows reach back over it into CTA 0), whose first
# segment is padding (later windows reach into the carried window), and
# with fewer valid elements than the window (k5_ring_lookback_inputs)
K5_RING_LOOKBACK = (4, 128, 100)
# EDDM's squared distances past 2^24 (ROADMAP C11): rows with an error
# every 700–1,299 elements, in windows of this shape, from a fresh state and
# from a carried d2_sum past 2^24 (on the one-CTA path), and the probe rows'
# first 16,000 elements on the cluster path (8 CTAs)
K5_EDDM_PROBE = (3, 600, 100)
K5_EDDM_CLUSTER_PROBE = (3, 160, 100)


def k5_inputs(rng, p, w, b, first_change=False):
    """K1's inputs, plus an all-zero first half in partition 2 (HDDM-W key
    ties once v converges) and, with ``first_change``, an error in each
    row's first element."""
    errs, valid = ddm_inputs(rng, p, w, b)
    if p > 2:
        errs[2].reshape(-1)[: (w * b) // 2] = 0.0
    if first_change:
        errs[:, 0, 0] = 1.0
        valid[:, 0, 0] = True
    return errs, valid


def k5_ring_lookback_inputs(rng, p, n, wr):
    """Rows for the ring members' look-backs across CTAs: error rate 0.05,
    then 0.6 from a third of the row; row 0's second 2048-element segment
    padding, row 1's first, row 2 with ``wr // 2`` valid elements, the rest
    all valid."""
    errs = (rng.random((p, n)) < np.where(np.arange(n) < n // 3, 0.05, 0.6)).astype(np.float32)
    valid = np.ones((p, n), bool)
    valid[0, 2048:4096] = False
    valid[1, :2048] = False
    valid[2] = False
    valid[2, rng.choice(n, wr // 2, replace=False)] = True
    return errs, valid


def eddm_probe_rows(p, n):
    """``p`` rows of ``n`` 0/1 errors, one every 700–1,299 elements."""
    rows = np.zeros((p, n), np.float32)
    for seed in range(p):
        pos = np.cumsum(np.random.default_rng(seed).integers(700, 1300, n // 700 + 1))
        rows[seed, pos[pos < n]] = 1.0
    return rows


def check_k5_equal(torch, got, want, what):
    torch.cuda.synchronize()
    for g, r in zip(got[0] + got[1], want[0] + want[1]):
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        check(torch.equal(g, r), f"{what} differs from its plain version")


def check_k5(torch, kernels, config, name, p, w, b, dev):
    """Zoo kernel ``name`` against its plain version at the main path's
    shape and the edge shapes, from fresh and carried states; times it;
    returns its kernel row."""
    from distributed_drift_detection_tpu_torch.ops import adwin, detectors

    info = zoo_table(config)[name]
    window = wrappers()[name]
    rng = np.random.default_rng(5)
    edges = (K5_EDGES + (K5_CLUSTER_EDGES if name in CLUSTER_KERNELS else [])
             + (K5_RING_EDGES if name in RING_KERNELS else []))
    for shape in [(p, w, b)] + edges:
        for prm in info["params"]:
            if getattr(prm, "clock", 32) == 1 and shape[1] * shape[2] > 2000:
                continue  # ADWIN's plain version flushes per element there
            for first in (False, True):
                e0, v0 = (torch.from_numpy(a).to(dev) for a in k5_inputs(rng, shape[0], 3, 40))
                e1, v1 = (torch.from_numpy(a).to(dev)
                          for a in k5_inputs(rng, *shape, first_change=first))
                fresh = info["init"](prm, shape[0], dev)
                carried, _ = info["reference"](fresh, e0, v0, prm)
                for state in (fresh, carried):
                    check_k5_equal(torch, window(state, e1, v1, prm),
                                   info["reference"](state, e1, v1, prm),
                                   f"{name} {shape} {prm}")
    extra = ""
    if name == "eddm_window":
        ep, ew, eb = K5_EDDM_PROBE
        e1 = torch.from_numpy(eddm_probe_rows(ep, ew * eb).reshape(ep, ew, eb)).to(dev)
        v1 = torch.ones_like(e1, dtype=torch.bool)
        cp, cw, cb = K5_EDDM_CLUSTER_PROBE
        e2 = e1.view(ep, -1)[:, : cw * cb].reshape(cp, cw, cb).contiguous()
        v2 = torch.ones_like(e2, dtype=torch.bool)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        check(detectors.cluster_ctas(ep, ew * eb, sms) == 0
              and detectors.cluster_ctas(cp, cw * cb, sms) > 0, "the EDDM probes' paths")
        for prm in info["params"]:
            fresh = info["init"](prm, ep, dev)
            carried, _ = info["reference"](fresh, e1, v1, prm)
            check(float(carried.d2_sum.min()) > 2.0**24, "the EDDM probe's d2_sum")
            for state in (fresh, carried):
                check_k5_equal(torch, window(state, e1, v1, prm),
                               info["reference"](state, e1, v1, prm), f"{name} probe {prm}")
                check_k5_equal(torch, window(state, e2, v2, prm),
                               info["reference"](state, e2, v2, prm),
                               f"{name} cluster probe {prm}")
        extra = (f"; the sums past 2^24 at [{ep}, {ew}x{eb}] (one-CTA path) and [{cp}, "
                 f"{cw}x{cb}] (cluster path; an error every 700-1,299 elements, carried "
                 f"d2_sum up to {float(carried.d2_sum.max()):,.0f})")
    if name in RING_KERNELS:
        lp, lw, lb = K5_RING_LOOKBACK
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        long_prm = (config.KSWINParams(window_size=2500, stat_size=700) if name == "kswin_window"
                    else config.STEPDParams(window_size=2500))
        check(detectors.ring_ctas(lp, lw * lb, 2500, sms) == 7, "the ring look-back's path")
        e1, v1 = (torch.from_numpy(a.reshape(lp, lw, lb)).to(dev)
                  for a in k5_ring_lookback_inputs(rng, lp, lw * lb, 2500))
        for prm in info["params"] + [long_prm]:
            fresh = info["init"](prm, lp, dev)
            e0, v0 = (torch.from_numpy(a).to(dev) for a in k5_inputs(rng, lp, 3, 40))
            carried, _ = info["reference"](fresh, e0, v0, prm)
            for state in (fresh, carried):
                check_k5_equal(torch, window(state, e1, v1, prm),
                               info["reference"](state, e1, v1, prm), f"{name} look-back {prm}")
        extra = (f"; look-backs across the CTAs at [{lp}, {lw}x{lb}] (7 CTAs; a padding "
                 "segment, a padded first segment, fewer valid elements than the window; "
                 f"window_size {info['params'][0].window_size}, "
                 f"{info['params'][1].window_size} and 2500)")
    print(f"K5 {name}: equal to its plain version at [{p}, {w}x{b}] and "
          + ", ".join(f"[{a}, {c}x{d}]" for a, c, d in edges)
          + f", {len(info['params'])} parameter sets, fresh and carried states" + extra)

    prm = info["params"][0]
    e1, v1 = (torch.from_numpy(a).to(dev) for a in k5_inputs(np.random.default_rng(1), p, w, b))
    e0, v0 = (torch.from_numpy(a).to(dev) for a in k5_inputs(np.random.default_rng(2), p, 3, 40))
    state, _ = info["reference"](info["init"](prm, p, dev), e0, v0, prm)
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty_like(fw)
    end = type(state)(*(torch.empty_like(leaf) for leaf in state))
    floor_args = None
    if name == "adwin_window":
        scratch = adwin.adwin_scratch(p, w * b, prm, dev)
        args = adwin.adwin_window_args(state, e1, v1, prm, fw, fc, end, scratch)
    elif name in RING_KERNELS:
        ctas = detectors.ring_ctas(p, w * b, prm.window_size, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        scratch = detectors.ring_scratch(name, p, w, b, prm.window_size, ctas, dev)
        args = getattr(detectors, f"{name}_args")(state, e1, v1, prm, fw, fc, end, scratch,
                                                  ctas)
        floor_args = (p, w, b, prm.window_size, ctas)
        print(f"K5 {name}: timed on its {'cluster' if ctas else 'one-CTA'} path, "
              f"{ctas} CTAs a row")
    else:
        ctas = detectors.cluster_ctas(p, w * b, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        if name == "hddm_window":
            args = detectors.hddm_window_args(state, e1, v1, prm, fw, fc, end, ctas)
        elif name == "eddm_window":
            args = detectors.eddm_window_args(state, e1, v1, prm, fw, fc, end,
                                              detectors.eddm_scratch(p, w, b, ctas, dev), ctas)
        else:
            scratch_of, args_of = {
                "ph_window": (detectors.ph_scratch, detectors.ph_window_args),
                "hddm_w_window": (detectors.hddm_w_scratch, detectors.hddm_w_window_args),
            }[name]
            args = args_of(state, e1, v1, prm, fw, fc, end, scratch_of(p, w * b, ctas, dev),
                           ctas)
        if name in ("eddm_window", "hddm_window"):
            floor_args = (p, w, b, ctas)
        print(f"K5 {name}: timed on its {'cluster' if ctas else 'one-CTA'} path, "
              f"{ctas} CTAs a row")
    fn = kernels.launcher(name)
    ms = graph_ms(lambda: kernels.check(name, fn(*args, kernels.stream_handle(dev))))
    floor_ms = None
    if floor_args is not None:
        floor = kernels.launcher(f"{name}_floor")
        floor_ms = graph_ms(lambda: kernels.check(
            f"{name}_floor", floor(*floor_args, kernels.stream_handle(dev))))
    h_us = host_us(lambda: window(state, e1, v1, prm))
    plain_ms = time_ms(lambda: info["reference"](state, e1, v1, prm), reps=10, rounds=3)
    n = p * w * b
    state_bytes = sum(leaf.numel() * leaf.element_size() for leaf in state)
    # errs f32 + live u8 per element, the state read and written, [P, W]
    # i32 twice written; the element operations of the statistic
    b_ms, by = bound(n * 5 + 2 * state_bytes + p * w * 8, n * info["ops_per_element"])
    print(f"K5 {name} [{p}, {w}x{b}]: {ms:.5f} ms device (graph of 50), "
          f"{h_us:.1f} us host a call, {plain_ms:.4f} ms plain, bound "
          f"{b_ms:.5f} ms ({by})"
          + ("" if floor_ms is None else f", floor {floor_ms:.5f} ms (an empty kernel with "
             "its grid, cluster, block and dynamic shared memory)"))
    row = dict(
        name=name, route="cuda",
        source=f"distributed_drift_detection_tpu_torch/csrc/{name}.cu",
        replaces=info["replaces"], max_abs_err=0.0, ms=ms, host_us=h_us,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
    )
    if floor_ms is not None:
        row["floor_ms"] = floor_ms
    if name == "adwin_window":
        # the rows' flush chains run side by side, one CTA each: the
        # longest one is the launch's chain
        n_flush = (state.t % prm.clock + v1.flatten(1).sum(1, dtype=torch.int32)) // prm.clock
        row["flushes"] = int(n_flush.max())
        row["us_per_flush"] = ms * 1e3 / row["flushes"]
        print(f"K5 {name}: {row['flushes']} flushes in the longest row, "
              f"{row['us_per_flush']:.4f} us a flush")
    return row


def run_equal(api, np_, cfg, dev, what):
    """Run ``cfg`` on the card with the launch counters reset just before
    and read just after; check the flags and vote against the port's CPU
    run. Returns (card result, launches)."""
    ref = api.run(cfg, device="cpu")
    reset_launches()
    res = api.run(cfg, device=dev)
    launches = read_launches()
    for f in res.flags._fields:
        check(np_.array_equal(getattr(res.flags, f), getattr(ref.flags, f)),
              f"{what}: flags.{f} differ between the card and the CPU")
    check(np_.array_equal(res.drift_vote, ref.drift_vote), f"{what}: drift vote differs")
    check(bool(np_.isfinite(res.drift_vote).all()), f"{what}: non-finite drift vote")
    return res, launches


KERNEL_SYMBOLS = {"ddm_window": "ddm_window_kernel",
                  "centroid_predict_err": "centroid_predict_err_kernel",
                  "centroid_fit": "centroid_fit_kernel",
                  "ph_window": "ph_window_kernel",
                  "eddm_window": "eddm_window_kernel",
                  "hddm_window": "hddm_window_kernel",
                  "hddm_w_window": "hddm_w_window_kernel",
                  "kswin_window": "kswin_window_kernel",
                  "stepd_window": "stepd_window_kernel",
                  "adwin_window": "adwin_window_kernel",
                  "random_normal": "init_normals_kernel",
                  "mlp_fit": "mlp_fit_kernel",
                  "mlp_predict_err": "mlp_predict_err_kernel",
                  "forest_fit": "forest_fit_kernel",
                  "forest_predict_err": "forest_predict_err_kernel",
                  "soak_batch": "soak_tile_kernel",
                  "shuffle_perm": "shuffle_perm_kernel"}


def kernel_hits(kern, name) -> list:
    """The profiler's events of kernel ``name``: its symbol at the start of
    a name (``ddm_window_kernel`` is inside ``eddm_window_kernel``; K5-ph's
    cluster path is ``ph_window_kernel_cluster``)."""
    import re

    pat = re.compile(rf"(?<![A-Za-z0-9_]){KERNEL_SYMBOLS[name]}")
    return [e for e in kern if pat.search(e.key)]


def traced(torch, run) -> tuple[list, float]:
    """``run()`` twice in one ``torch.profiler`` session: the device events
    of the second (``key_averages``) and its host seconds. The first is a
    warm-up the profiler discards: a session's first kernel records can go
    missing after the earlier sessions of this script (a traced phase lost
    its first ≈ 20 kernels so, among them the mlp's one K8 launch)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    got = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.setdefault("events", p.key_averages())) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        prof.step()
    cuda = torch.autograd.DeviceType.CUDA
    # the schedule's step annotation also lies on the device's timeline
    return [e for e in got.get("events", ())
            if e.device_type == cuda and not e.key.startswith("ProfilerStep")], seconds


def in_run_profile(torch, api, prep, dev,
                   names=("ddm_window", "centroid_predict_err", "centroid_fit")):
    """One warm detect phase under ``torch.profiler`` (:func:`traced`): each
    of the kernels ``names``' (launches, device µs per launch), and the
    summary of the phase."""
    batches = api.upload(prep.batches, dev)
    prep.runner(batches)
    torch.cuda.synchronize()
    kern, detect_s = traced(torch, lambda: prep.runner(batches))
    check(bool(kern), "the profiler saw no device kernels in the detect phase")
    busy_us = sum(e.self_device_time_total for e in kern)
    per = {}
    for name in names:
        hits = kernel_hits(kern, name)
        count = sum(e.count for e in hits)
        check(count > 0, f"the profiler saw no {name} launch in the detect phase")
        per[name] = (count, sum(e.self_device_time_total for e in hits) / count)
    summary = {"detect_s": detect_s, "kernels": sum(e.count for e in kern),
               "busy_s": busy_us / 1e6, "idle_share": 1.0 - busy_us / 1e6 / detect_s}
    return per, summary


def later_phases(torch, api, config, kernels, cfg, res, mcfg, mprep, final_times, dev):
    """Phases 11 to 14 (module docstring) after the main path's run ``res``
    of ``cfg`` and the mlp's ``mcfg``/``mprep``: adds to ``final_times``;
    returns the forest's kernel rows and K7's and K2's wide-row times."""
    from distributed_drift_detection_tpu_torch.io import native
    from distributed_drift_detection_tpu_torch.models import classifiers, mlp

    p = cfg.partitions
    # 11. CSV ingest: SMOKE's twin written as a CSV, under strict on the
    # card (the main path's numbers and flags); a dirty copy under
    # quarantine and repair (masked rows on the dense striper), counted
    import tempfile

    tmp = tempfile.TemporaryDirectory()
    twin = f"{tmp.name}/twin.csv"
    write_csv(SMOKE["dataset"][len("synth:"):], twin)
    csv_cfg = config.replace(cfg, dataset=twin)
    reset_launches()
    cres = api.run(csv_cfg, device=dev)
    cl = read_launches()
    cm = cres.metrics
    print(f"CSV twin ({'native' if native.native_available() else 'NumPy'} parser, strict) on "
          f"the card: {cm.num_detections} detections, mean delay {cm.mean_delay_rows:.4f} rows, "
          f"flags {'equal' if flags_equal(np, cres, res) else 'NOT equal'} to the synth: run; "
          f"launches {cl}")
    check(cm.num_detections == EXPECTED_DETECTIONS and
          abs(cm.mean_delay_rows - EXPECTED_MEAN_DELAY) < 0.01,
          f"CSV twin: {cm.num_detections} detections, {cm.mean_delay_rows} rows")
    check(flags_equal(np, cres, res), "CSV twin: flags differ from the synth: run's")
    for k in ("ddm_window", "centroid_predict_err", "centroid_fit"):
        check(cl[k] > 0, f"CSV twin: kernel {k} was not launched")
    dirty = f"{tmp.name}/dirty.csv"
    write_csv(SMOKE["dataset"][len("synth:"):], dirty, dirty=True)
    for policy, (want_n, want_delay) in DIRTY_EXPECTED.items():
        dcfg = config.replace(cfg, dataset=dirty, data_policy=policy,
                              quarantine_path=f"{tmp.name}/{policy}.jsonl")
        dres, dl = run_equal(api, np, dcfg, dev, f"dirty CSV ({policy})")
        dm = dres.metrics
        dtimes = [api.run(dcfg, device=dev) for _ in range(3)]
        final_times[f"csv {policy}"] = statistics.median(t.total_time for t in dtimes)
        upload = statistics.median(t.timings["upload"] for t in dtimes)
        print(f"dirty CSV ({policy}) on the card: {dm.num_detections} detections, mean delay "
              f"{dm.mean_delay_rows:.4f} rows (the JAX package: {want_n}, {want_delay}), "
              f"{dres.stream.quarantine.rows_quarantined} rows quarantined, flags equal to the "
              f"CPU run; Final Time (median of 3 warm runs) {final_times[f'csv {policy}']:.4f} s, "
              f"upload of the dense stream {upload:.4f} s; launches {dl}")
        check(dm.num_detections == want_n and abs(dm.mean_delay_rows - want_delay) < 0.01,
              f"dirty CSV ({policy}): {dm.num_detections} detections, {dm.mean_delay_rows} rows")
        for k in ("ddm_window", "centroid_predict_err", "centroid_fit"):
            check(dl[k] > 0, f"dirty CSV ({policy}): kernel {k} was not launched")
    # ROADMAP C8: the dirty CSV under quarantine through the zoo kernels,
    # the mlp and the forest (mult_data C8_MULT), flags equal to the CPU's
    for what, kw in C8_RUNS:
        qcfg = config.replace(cfg, dataset=dirty, data_policy="quarantine",
                              quarantine_path=f"{tmp.name}/c8-{what}.jsonl",
                              mult_data=C8_MULT, **kw)
        t0 = time.perf_counter()
        qres, ql = run_equal(api, np, qcfg, dev, f"dirty CSV ({what}, quarantine)")
        path = ([api.DETECTOR_KERNELS[kw["detector"]]] if "detector" in kw else []) + list(
            api.MODEL_KERNELS.get(kw.get("model", "centroid"), ()))
        for k in path:
            check(ql[k] > 0, f"dirty CSV ({what}, quarantine): kernel {k} was not launched")
        print(f"dirty CSV ({what}, quarantine, mult_data {C8_MULT}) on the card: "
              f"{qres.metrics.num_detections} detections, mean delay "
              f"{qres.metrics.mean_delay_rows:.4f} rows, "
              f"{qres.stream.quarantine.rows_quarantined} rows quarantined, flags equal to the "
              f"CPU run ({time.perf_counter() - t0:.1f} s both); launches "
              f"{ {k: v for k, v in ql.items() if v} }")

    # 12. wide rows: a centroid run on a CSV of F = 2,048 (K7's features in
    # chunks), counted; K2 at F = 60,000 (its features in chunks)
    wide = f"{tmp.name}/wide.csv"
    write_csv(WIDE_SPEC, wide)
    wcfg = config.replace(cfg, dataset=wide, mult_data=WIDE_MULT)
    wres, wl = run_equal(api, np, wcfg, dev, "F = 2,048")
    print(f"F = 2,048 centroid run (mult_data {WIDE_MULT}) on the card: "
          f"{wres.metrics.num_detections} detections, flags equal to the CPU run; launches {wl}")
    check(wl["centroid_fit"] > 0 and wl["centroid_predict_err"] > 0,
          "F = 2,048: K7 or K2 was not launched")
    check(wres.metrics.num_detections == WIDE_EXPECTED,
          f"F = 2,048: {wres.metrics.num_detections} detections, expected {WIDE_EXPECTED}")
    wide_ms = wide_times(torch, kernels, classifiers, api.prepare(wcfg, device=dev), dev)
    kp, kn, kc, kf = K2_FEATURE_CHUNKS
    krng = np.random.default_rng(kf)
    kcent = torch.from_numpy(krng.normal(size=(kp, kc, kf)).astype(np.float32)).to(dev)
    kbias = torch.from_numpy(krng.normal(size=(kp, kc)).astype(np.float32)).to(dev)
    kT = torch.from_numpy(krng.normal(size=(64, kf)).astype(np.float32)).to(dev)
    kTy = torch.from_numpy(krng.integers(0, kc, 64).astype(np.int32)).to(dev)
    kidx = torch.from_numpy(krng.integers(0, 64, (kp, kn)).astype(np.int32)).to(dev)
    kerr, kpred = classifiers.centroid_predict_err(kcent, kbias, kT, kTy, kidx, return_pred=True)
    _, rpred = classifiers.centroid_predict_err_reference(kcent, kbias, kT, kTy, kidx)
    scores = torch.bmm(kT[kidx.long()].double(), kcent.double().transpose(1, 2)) + kbias.double()[:, None]
    top2 = scores.topk(2, -1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 1e-4 * (1 + top2[..., 0].abs())
    check(torch.equal(kpred[~tie], rpred[~tie]), "K2 at F = 60,000 differs off the near ties")
    check(torch.equal(kerr, (kpred != kTy[kidx.long()]).float()), "K2 at F = 60,000: errors")
    kfn = kernels.launcher("centroid_predict_err")
    kerr2 = torch.empty_like(kerr)
    kargs = classifiers.centroid_predict_err_args(kcent, kbias, classifiers.pad_row_table(kT), kTy,
                                                  kidx, kerr2)
    k2_ms = graph_ms(lambda: kernels.check("centroid_predict_err",
                                           kfn(*kargs, kernels.stream_handle(dev))),
                     reps=10, rounds=3)
    print(f"K2 at F = {kf} (features in chunks): predictions equal to its plain version off "
          f"{int(tie.sum())} near ties; [{kp}, {kn}] C={kc}: {k2_ms:.5f} ms device (graph of 10)")
    wide_ms["K2 F=60000 [2, 300] C=5"] = k2_ms

    # 13. the forest: K11 and K12 against their plain versions, then its
    # path at SMOKE's full width and depth, counted
    from distributed_drift_detection_tpu_torch.models import forest

    fcfg = config.replace(cfg, model="forest")
    fprep = api.prepare(fcfg, device=dev)
    check((fprep.config.forest_trees, fprep.config.forest_depth, fprep.config.window,
           fprep.config.window_rotations, fprep.config.retrain_error_threshold) == (32, 3, 128, 4, 0.3),
          f"the forest path resolved to {fprep.config}")
    rows = check_k11_k12(torch, kernels, forest, fprep, dev)
    t0 = time.perf_counter()
    fref = api.run(fcfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    reset_launches()
    fres = api.run(fcfg, device=dev)
    fl = read_launches()
    fm, want_n, want_delay = fres.metrics, *FOREST_EXPECTED
    print(f"forest on the card: {fm.num_detections} detections, mean delay "
          f"{fm.mean_delay_rows:.4f} rows (the JAX package: {want_n}, {want_delay:.4f}); flags "
          f"{'equal' if flags_equal(np, fres, fref) else 'NOT equal'} bit for bit to the port's "
          f"CPU run ({fref.metrics.num_detections} detections, "
          f"{fref.metrics.mean_delay_rows:.4f} rows, {cpu_s:.1f} s); launches {fl}")
    check(fm.num_detections == want_n, f"forest: {fm.num_detections} detections, expected {want_n}")
    check(abs(fm.mean_delay_rows - want_delay) <= cfg.per_batch,
          f"forest: mean delay {fm.mean_delay_rows}, more than a batch from {want_delay}")
    check(bool(np.isfinite(fres.drift_vote).all()), "forest: non-finite drift vote")
    for k in ("forest_fit", "forest_predict_err", "ddm_window"):
        check(fl[k] > 0, f"forest: kernel {k} was not launched on its path")
    ftimes = [api.run(fcfg, device=dev) for _ in range(3)]
    final_times["forest"] = statistics.median(t.total_time for t in ftimes)
    names = ("forest_fit", "forest_predict_err")
    fper, fsum = in_run_profile(torch, api, fprep, dev, names + ("ddm_window",))
    for row in rows[-2:]:
        row["launches"] = fl[row["name"]]
        row["in_run_launches"], row["in_run_us"] = fper[row["name"]]
    print(f"forest: Final Time (median of 3 warm runs) {final_times['forest']:.4f} s; in-run "
          + ", ".join(f"{k} {fper[k][0]} launches x {fper[k][1]:.2f} us" for k in names)
          + f"; {fsum['kernels']} kernels busy {fsum['busy_s']:.4f} s of "
          f"{fsum['detect_s']:.4f} s, idle share {fsum['idle_share']:.3f}")

    # 14. the deep mlp: 65 layers, past the 64 a launch's parameters hold,
    # through K9 and K10 against their plain versions, then a short run
    deep = (mprep.stream.num_features, *DEEP_HIDDEN, mprep.stream.num_classes)
    _, dkeys = mlp_keys(torch, mprep, dev)
    dmain = [torch.from_numpy(a).to(dev) for a in k7_main_batch(mprep.batches)]
    init = mlp.mlp_init(dkeys, deep)
    zero = mlp.mlp_fit(dkeys, *dmain, deep, 0, 0.05)
    check(all(torch.equal(z.w.view(torch.int32), i.w.view(torch.int32)) and torch.equal(z.b, i.b)
              for z, i in zip(zero, init)), "K9's init differs from the plain init (65 layers)")
    dparams = mlp.mlp_fit(dkeys, *dmain, deep, 2, 0.05)
    dgap = fit_gap(torch, dparams, mlp.mlp_fit_reference(dkeys, *dmain, deep, 2, 0.05, 0.9))
    check(dgap <= K9_ATOL, f"K9 differs from its plain version by {dgap} (65 layers)")
    dT, dTy, didx = (torch.from_numpy(a).to(dev) for a in k10_main_inputs(mprep.stream, p, 2000))
    dties, ddiff = check_k10_equal(torch, mlp, dparams, dT, dTy, didx, "65 layers")
    dcfg = config.replace(mcfg, mlp_hidden=DEEP_HIDDEN, fit_steps=2, mult_data=DEEP_MULT)
    dres, dl = None, None
    reset_launches()
    dres = api.run(dcfg, device=dev)
    dl = read_launches()
    check(dl["mlp_fit"] > 0 and dl["mlp_predict_err"] > 0, "65 layers: K9 or K10 not launched")
    check(bool(np.isfinite(dres.drift_vote).all()), "65 layers: non-finite drift vote")
    print(f"mlp of 65 layers {deep[:2]}..{deep[-2:]}: K9's init bit for bit, its fit "
          f"{dgap:.3g} from its plain version after 2 steps (within {K9_ATOL}), K10 equal off "
          f"{dties} near ties "
          f"({ddiff} predictions differ) at [{p}, 2000]; run (mult_data {DEEP_MULT}, 2 steps) "
          f"{dres.metrics.num_detections} detections, launches {dl}")
    tmp.cleanup()
    return rows, wide_ms



def run_cli(tmp: str, cache: str) -> tuple[str, float]:
    """``python -m distributed_drift_detection_tpu_torch`` with the
    reference's argv on SMOKE's CSV twin in ``tmp``, its kernels built into
    and loaded from ``cache``: its summary line and wall seconds."""
    import os

    argv = [sys.executable, "-m", "distributed_drift_detection_tpu_torch",
            "--compile-cache-dir", cache, "jax://local", "16", "8g", "4",
            time.strftime("%a_%b_%d_%H:%M:%S_%Y"), "512", "outdoorStream.csv"]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=tmp, env=env, capture_output=True, text=True,
                          timeout=300, check=False)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("rows=")]
    check(len(lines) == 1, f"the CLI printed no summary line: {proc.stdout[-2000:]}")
    return lines[0], wall


def cache_files(cache: str) -> dict:
    """Each file of the build directory, by name: (inode, mtime in ns) —
    a rebuilt library is a new file (``os.replace``)."""
    import os

    return {e.name: (e.stat().st_ino, e.stat().st_mtime_ns) for e in os.scandir(cache)
            if e.name.endswith(".so")}


def experiment_phase(torch, api, config, dev) -> None:
    """Phase 15 (module docstring): the CLI, the resumable grid, rf, the
    delay-parity harness and ``doctor``, all on the card."""
    import os
    import tempfile

    from distributed_drift_detection_tpu_torch.harness import grid, parity
    from distributed_drift_detection_tpu_torch.io import sanitize
    from distributed_drift_detection_tpu_torch.results import read_results

    tmp = tempfile.TemporaryDirectory()
    twin = os.path.join(tmp.name, "outdoorStream.csv")
    write_csv(SMOKE["dataset"][len("synth:"):], twin)
    t_phase = time.perf_counter()

    # (a) the CLI, twice on one fresh build directory: the second run loads
    # the libraries the first built and runs no nvcc
    cache = os.path.join(tmp.name, "kernels")
    line1, wall1 = run_cli(tmp.name, cache)
    built = cache_files(cache)
    line2, wall2 = run_cli(tmp.name, cache)
    for line in (line1, line2):
        check(line.startswith(CLI_EXPECTED + " final_time="),
              f"the CLI printed {line!r}, expected {CLI_EXPECTED!r} up to final_time")
    check(len(built) == 4 and {n.split("-")[0] for n in built} == {
        "libddm_window", "libcentroid_fit", "libcentroid_predict_err", "libddd_native"},
        f"the CLI's build directory holds {sorted(built)}")
    check(cache_files(cache) == built, "the second CLI run rebuilt a library")
    cli_rows = read_results(os.path.join(tmp.name, "ddm_cluster_runs.csv"))
    check(len(cli_rows) == 2 and all(r["Detections"] == "624" and r["Instances"] == "16"
                                     for r in cli_rows),
          f"the CLI's results rows: {cli_rows}")
    print(f"CLI (python -m distributed_drift_detection_tpu_torch ... 512 outdoorStream.csv) on "
          f"the card: {line1}; again on the same --compile-cache-dir: {line2}, its "
          f"{len(built)} libraries not rebuilt (wall {wall1:.1f} s, then {wall2:.1f} s); "
          f"both rows read back through read_results")

    # (b) the scaleup grid: 8 recorded trials on the card, each against the
    # same trial run on the CPU; then the resume
    on_card = os.path.join(tmp.name, "grid_card.csv")
    on_cpu = os.path.join(tmp.name, "grid_cpu.csv")
    shape = dict(mults=list(GRID_MULTS), partitions=list(GRID_PARTITIONS), trials=GRID_TRIALS)
    msgs = []
    base = config.RunConfig(dataset=twin, results_csv=on_card)
    n = grid.run_grid(base, **shape, warmup=True, progress=msgs.append, device=dev)
    check(n == 8 and not any("off-spec" in m for m in msgs), f"the grid ran {n} trials: {msgs}")
    t0 = time.perf_counter()
    grid.run_grid(config.replace(base, results_csv=on_cpu), **shape, progress=lambda *_: None,
                  device="cpu")
    cpu_s = time.perf_counter() - t0
    card_rows, cpu_rows = read_results(on_card), read_results(on_cpu)
    timed = ("Final Time", "Rows Per Sec")
    for a, b in zip(card_rows, cpu_rows):
        check({k: v for k, v in a.items() if k not in timed}
              == {k: v for k, v in b.items() if k not in timed},
              f"grid trial {a['Spark App']}: the card's row {a} differs from the CPU's {b}")
    check(len(card_rows) == len(cpu_rows) == 8, "the grid recorded other than 8 trials")
    for r in card_rows:
        print(f"grid trial on the card: mult {float(r['Data Multiplier']):g}, "
              f"{r['Instances']} partitions, {r['Rows']} rows: Final Time {r['Final Time']} s, "
              f"{float(r['Rows Per Sec']):,.0f} rows/s, {r['Detections']} detections, mean delay "
              f"{float(r['Average Distance']):.4f} rows (equal to the CPU run)")
    again = grid.run_grid(base, **shape, progress=lambda *_: None, device=dev)
    with open(on_card, "rb") as fh:
        data = fh.read()
    last = data.rstrip(b"\r\n").rfind(b"\n") + 1
    with open(on_card, "wb") as fh:
        fh.write(data[: last + (len(data) - last) // 2])
    torn = grid.run_grid(base, **shape, progress=lambda *_: None, device=dev)
    check((again, torn) == (0, 1), f"the grid's resume ran {again}, then {torn} after a torn row")
    print(f"grid (mults {GRID_MULTS} x partitions {GRID_PARTITIONS} x {GRID_TRIALS} trials, "
          f"warm-up on): 8 trials equal to their CPU runs ({cpu_s:.1f} s on the CPU); resume "
          f"ran {again}, then {torn} with the last row torn halfway")

    # (c) rf: the reference's host RandomForest, which needs scikit-learn
    import importlib.util

    rcfg = config.RunConfig(**RF_SMALL)
    if importlib.util.find_spec("sklearn") is None:
        before = torch.cuda.memory_allocated(dev)
        try:
            api.run(rcfg, device=dev)
            fail("rf ran without scikit-learn")
        except ImportError as e:
            check("scikit-learn" in str(e), f"rf raised {e!r}")
            msg = str(e)
        check(torch.cuda.memory_allocated(dev) == before, "rf allocated on the card before raising")
        print(f"rf on the card: no scikit-learn here; raises ImportError before any work: {msg}")
    else:
        rres, rref = api.run(rcfg, device=dev), api.run(rcfg, device="cpu")
        check(flags_equal(np, rres, rref), "rf: flags differ between the card and the CPU")
        print(f"rf on the card (scikit-learn present): {rres.metrics.num_detections} "
              "detections, flags equal to the CPU run")

    # (d) the delay-parity harness on the card against the CPU
    ds, mult, parts = PARITY_GEOMETRY
    pkw = dict(models=PARITY_MODELS, dataset=ds, mult_data=mult, partitions=parts,
               per_batch=100, seeds=range(1))
    reset_launches()
    card = parity.measure_delay_parity(**pkw, device=dev)
    pl = read_launches()
    t0 = time.perf_counter()
    cpu = parity.measure_delay_parity(**pkw, device="cpu")
    pcpu_s = time.perf_counter() - t0
    for a, b in zip(card, cpu):
        if a["model"] in PARITY_FITTED:
            check(a["detections"] == b["detections"]
                  and abs(a["mean_delay_rows"] - b["mean_delay_rows"]) <= 100,
                  f"parity {a['model']}: the card's row {a} is more than a batch from {b}")
        else:
            check(json.dumps(a) == json.dumps(b),  # NaN equal to NaN
                  f"parity {a['model']}: the card's row {a} differs from the CPU's {b}")
        print(f"parity on the card ({ds} x{mult:g}, {parts} partitions, seed 0): {a['model']} "
              f"{a['detections']} detections, mean delay {a['mean_delay_rows']} rows (CPU "
              f"{b['detections']}, {b['mean_delay_rows']}), recall {a['recall']}")
    for k in ("ddm_window", "centroid_fit", "centroid_predict_err", "random_normal", "mlp_fit",
              "mlp_predict_err", "forest_fit", "forest_predict_err"):
        check(pl[k] > 0, f"parity: kernel {k} was not launched")
    print(f"parity: {len(card)} rows match the CPU's ({pcpu_s:.1f} s on the CPU); "
          f"launches {pl}")

    # (e) doctor on the twin and on phase 11's dirty CSV
    dirty = os.path.join(tmp.name, "dirty.csv")
    write_csv(SMOKE["dataset"][len("synth:"):], dirty, dirty=True)
    codes = []
    for path in (twin, dirty):
        try:
            sanitize.main([path])
            codes.append(0)
        except SystemExit as e:
            codes.append(e.code)
    check(codes == [0, 1], f"doctor exited {codes} on the twin and the dirty CSV")
    print(f"doctor: exit {codes[0]} on the twin, {codes[1]} on the dirty CSV; phase 15 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()
    return cpu_rows


def heal_main(argv: list[str], device: str = "cuda") -> int:
    """``heal`` (``resilience.heal.main``) in this process: its exit code."""
    from distributed_drift_detection_tpu_torch.resilience import heal

    try:
        heal.main(argv, device=device)
    except SystemExit as e:
        return int(e.code or 0)
    return 0


def worker_startup(tele: str, t_spawn: float) -> dict:
    """Each spawned worker's start-up, from the scheduler's journal and its
    first cell's run log: seconds from spawn to its hello (interpreter and
    package, no torch), from the hello to its first cell's
    ``run_started`` (torch, ``api``, the supervisor), that cell's prepare
    phase (stream and kernel libraries loaded from the shared directory),
    and the sum through prepare: spawn to the first Final Time span."""
    import os

    from distributed_drift_detection_tpu_torch.telemetry import events, registry

    with open(os.path.join(tele, "sched.journal.jsonl")) as fh:
        journal = [json.loads(ln) for ln in fh]
    logs = {rec["log"]: rec for rec in registry.runs(tele).values() if rec.get("log")}
    out = {}
    for j in journal:
        if j["event"] != "worker_joined":
            continue
        pid = j["pid"]
        first = None
        for name in sorted(logs, key=lambda n: logs[n]["started_ts"]):
            if f"-{pid}-" in name:
                first = events.read_events(os.path.join(tele, name))
                break
        check(first is not None, f"worker {j['worker']} left no run log")
        started = first[0]["ts"]
        prepare = next(e["seconds"] for e in first
                       if e["type"] == "phase_completed" and e["phase"] == "prepare")
        out[j["worker"]] = {"hello_s": j["ts"] - t_spawn, "imports_s": started - j["ts"],
                            "prepare_s": prepare, "startup_s": started + prepare - t_spawn}
    return out


def fleet_phase(torch, api, config, dev, res, final, cpu_rows) -> None:
    """Phase 16 (module docstring): a telemetered run, the scheduler with
    two workers on the card, and crash then heal."""
    import os
    import tempfile

    from distributed_drift_detection_tpu_torch.harness import grid
    from distributed_drift_detection_tpu_torch.kernels import _build
    from distributed_drift_detection_tpu_torch.resilience import faults
    from distributed_drift_detection_tpu_torch.results import read_results
    from distributed_drift_detection_tpu_torch.sched.leases import audit_exactly_once
    from distributed_drift_detection_tpu_torch.sched.scheduler import Scheduler
    from distributed_drift_detection_tpu_torch.telemetry import events, registry

    tmp = tempfile.TemporaryDirectory()
    t_phase = time.perf_counter()
    main_path = ("ddm_window", "centroid_predict_err", "centroid_fit")

    # (a) the main path with a telemetry_dir
    tele_a = os.path.join(tmp.name, "run")
    cfg = config.RunConfig(**SMOKE)
    plain_outside, plain_final = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        p = api.run(cfg, device=dev)
        plain_outside.append(time.perf_counter() - t0 - p.timings["prepare"] - p.total_time)
        plain_final.append(p.total_time)
    reset_launches()
    t0 = time.perf_counter()
    tres = api.run(config.replace(cfg, telemetry_dir=tele_a), device=dev)
    wall = time.perf_counter() - t0
    tl = read_launches()
    m = tres.metrics
    check(m.num_detections == EXPECTED_DETECTIONS
          and abs(m.mean_delay_rows - EXPECTED_MEAN_DELAY) < 0.01,
          f"telemetered run: {m.num_detections} detections, mean delay {m.mean_delay_rows}")
    check(flags_equal(np, tres, res), "telemetered run: flags differ from phase 4's run")
    for k in main_path:
        check(tl[k] > 0, f"telemetered run: kernel {k} was not launched")
    with open(tres.telemetry_path) as fh:
        lines = [json.loads(ln) for ln in fh]
    for ev in lines:
        events.validate_event(ev)
    snaps = {e["when"]: e["stats"] for e in lines
             if e["type"] == "memory_snapshot" and e["source"] == "device"}
    check(set(snaps) == {"before_detect", "after_detect"}
          and all(s["bytes_in_use"] > 0 for s in snaps.values()),
          f"telemetered run: device memory snapshots {snaps}")
    (rec,) = registry.runs(tele_a).values()
    check(rec["status"] == "completed" and rec["detections"] == EXPECTED_DETECTIONS,
          f"telemetered run: registry {rec}")
    compile_ev = next(e for e in lines if e["type"] == "compile_completed")
    outside = wall - tres.timings["prepare"] - tres.total_time
    print(f"telemetered run on the card: {m.num_detections} detections, mean delay "
          f"{m.mean_delay_rows:.4f} rows, flags equal to phase 4's run; {len(lines)} log lines "
          f"valid; device bytes in use {snaps['before_detect']['bytes_in_use']:,} before, "
          f"{snaps['after_detect']['bytes_in_use']:,} after the detect phase (peak "
          f"{snaps['after_detect']['peak_bytes_in_use']:,}); registry completed; "
          f"compile_completed cached={compile_ev['cached']} seconds={compile_ev['seconds']:.4f}; "
          f"launches {tl}")
    print(f"telemetered run: Final Time {tres.total_time:.4f} s (untelemetered: the two runs "
          f"just before it {', '.join(f'{x:.4f}' for x in plain_final)} s, phase 4's median of 3 "
          f"{final:.4f} s); {outside:.4f} s of its {wall:.4f} s wall outside prepare "
          f"and the span (the bracket, the snapshots, the log and the exports; untelemetered "
          f"runs: {', '.join(f'{x:.4f}' for x in plain_outside)} s)")

    # (b) the scheduler: 4 cells of phase 15's grid, 2 workers on the card
    tele_b = os.path.join(tmp.name, "sched")
    twin = os.path.join(tmp.name, "outdoorStream.csv")
    write_csv(SMOKE["dataset"][len("synth:"):], twin)
    sched_csv = os.path.join(tmp.name, "sched.csv")
    spec = grid.sweep_spec(twin, list(GRID_MULTS), list(GRID_PARTITIONS), trials=1,
                           results_csv=sched_csv)
    sched = Scheduler(tele_b, lease_s=120.0)
    plan = sched.add_spec(spec)
    check(plan == {"cells_total": 4, "completed": 0, "queued": 4}, f"sched plan {plan}")
    sched.start()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("DDD_FAULTS", None)
    t_spawn = time.time()
    t0 = time.perf_counter()
    procs = sched.spawn_workers(
        2, extra_args=["--retries", "0", "--compile-cache-dir", str(_build.build_dir())],
        env=env)
    try:
        whole = sched.wait_whole(timeout=300)
        sweep_s = time.perf_counter() - t0
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        summary = sched.stop()
    check(whole and codes == [0, 0], f"sched: whole={whole}, worker exits {codes}, {summary}")
    check(summary["whole"] and summary["audit"]["ok"] and summary["completed"] == 4,
          f"sched summary {summary}")
    audit = audit_exactly_once(tele_b, sched.queue.expected_digests())
    check(audit["ok"], f"sched: exactly-once audit {audit}")
    # phase 15's CPU rows of trial 0, by cell (its twin lay elsewhere, so the
    # rows' app names and dataset paths differ)
    cpu_by = {(r["Data Multiplier"], r["Instances"]): r for r in cpu_rows
              if r["Spark App"].endswith("-t0")}
    timed = ("Final Time", "Rows Per Sec", "Exp Start Time", "Spark App", "Dataset")
    sched_rows = read_results(sched_csv)
    check(len(sched_rows) == 4, f"sched: {len(sched_rows)} results rows")
    for r in sched_rows:
        want = cpu_by.get((r["Data Multiplier"], r["Instances"]))
        check(want is not None and {k: v for k, v in r.items() if k not in timed}
              == {k: v for k, v in want.items() if k not in timed},
              f"sched cell {r['Spark App']}: {r} differs from the CPU run {want}")
        print(f"sched cell on the card: mult {float(r['Data Multiplier']):g}, {r['Instances']} "
              f"partitions: {r['Detections']} detections, mean delay "
              f"{float(r['Average Distance']):.4f} rows (equal to the CPU run), Final Time "
              f"{r['Final Time']} s")
    startup = worker_startup(tele_b, t_spawn)
    check(len(startup) == 2, f"sched: {len(startup)} workers joined")
    print(f"sched (2 workers on the card, one --compile-cache-dir): 4 cells exactly once in "
          f"{sweep_s:.2f} s wall from spawn; worker start-up "
          + "; ".join(f"{w}: {v['startup_s']:.2f} s to its first span (hello {v['hello_s']:.2f} s, "
                      f"torch and api {v['imports_s']:.2f} s, prepare {v['prepare_s']:.2f} s)"
                      for w, v in startup.items()))

    # (c) crash then heal
    tele_c = os.path.join(tmp.name, "heal")
    heal_csv = os.path.join(tmp.name, "heal.csv")
    spec_path = os.path.join(tmp.name, "heal_spec.json")
    with open(spec_path, "w") as fh:
        json.dump(grid.sweep_spec(twin, [GRID_MULTS[0]], list(GRID_PARTITIONS), trials=1,
                                  results_csv=heal_csv), fh)
    base = config.RunConfig(dataset=twin, results_csv=heal_csv)
    os.environ["DDD_FAULTS"] = "api.run:at=2"
    try:
        grid.run_grid(base, [GRID_MULTS[0]], list(GRID_PARTITIONS), trials=1,
                      telemetry_dir=tele_c, progress=lambda *_: None, device=dev)
        fail("the armed api.run fault did not crash the grid")
    except faults.InjectedFault:
        pass
    finally:
        del os.environ["DDD_FAULTS"]
        faults.disarm_all()
    statuses = sorted(r["status"] for r in registry.runs(tele_c).values() if not r.get("kind"))
    check(statuses == ["completed", "failed"], f"crashed grid: registry {statuses}")
    plan_path = os.path.join(tmp.name, "plan.json")
    code = heal_main([spec_path, "--telemetry-dir", tele_c, "--json", plan_path])
    with open(plan_path) as fh:
        missing = [c["app_name"] for c in json.load(fh)["missing"]]
    check(code == 1 and len(missing) == 1 and f"-p{GRID_PARTITIONS[1]}-" in missing[0],
          f"heal planned {missing}, exit {code}")
    reset_launches()
    t0 = time.perf_counter()
    code_exec = heal_main([spec_path, "--telemetry-dir", tele_c, "--execute", "--retries", "0"])
    heal_s = time.perf_counter() - t0
    hl = read_launches()
    code_after = heal_main([spec_path, "--telemetry-dir", tele_c])
    done = [r for r in registry.runs(tele_c).values() if not r.get("kind")]
    (heal_rec,) = [r for r in registry.runs(tele_c).values() if r.get("kind") == "heal"]
    check(code_exec == 0 and code_after == 0 and heal_rec["trials_run"] == 1
          and sorted(r["status"] for r in done) == ["completed", "completed", "failed"]
          and len(read_results(heal_csv)) == 2,
          f"heal --execute: exit {code_exec}, then {code_after}; {heal_rec}; {done}")
    for k in main_path:
        check(hl[k] > 0, f"heal --execute: kernel {k} was not launched")
    print(f"crash then heal on the card: api.run armed for cell 2 of 2; heal planned exactly "
          f"{missing[0]} (exit 1); heal --execute re-ran only it ({heal_s:.2f} s, launches "
          f"{hl}); the plan is whole (exit 0); phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()


# --- phase 17: the device-generated soak (A14) and the capture surfaces (A15b)

# bench.py's soak geometry (bench.py:216): 128 partitions x per_batch 2000,
# a concept every 100,000 rows, centroid ModelSpec(8, 8), prototypes, DDM
SOAK_P, SOAK_B, SOAK_DE = 128, 2000, 100_000
SOAK_ROWS, SOAK_LEG_ROWS = 10**9, 2**29
# each generator with its width and the centroid's classes
SOAK_GENS = (("prototypes", 8, 8), ("sea", 3, 2), ("hyperplane", 10, 2),
             ("hyperplane_gradual", 10, 2))
# the cut depth the card is held to the port's CPU run at (80 batches: 64
# concepts a run, every generator detecting)
SOAK_CUT = dict(partitions=16, per_batch=200, num_batches=80, drift_every=4000)
SOAK_CUT_WINDOW = 8
SOAK_CHAIN = dict(partitions=16, per_batch=200, total_rows=16 * 180 * 200,
                  drift_every=4000, max_leg_rows=16 * 60 * 200)
# K6's edge cases: (what, generator, F, P, B, drift_every, count, t0, last,
# rows, classes) — rows "global" (the one-shot runner's q·NB·B offsets),
# "local" (the chain's partition-local rows with concept offsets) or "top"
# (up to 2^31 - 2); each held in the plan's layout and under each `force`
K6_EDGES = [
    ("a batch straddling concept boundaries", "prototypes", 8, 16, 300, 700, 1, 9, 99, "global",
     8),
    ("nonzero block0, partition-local rows", "hyperplane_gradual", 10, 16, 300, 600, 1, 41,
     2**31 - 1, "local", 2),
    ("rows next to 2^31 - 1", "prototypes", 5, 4, 1000, 777, 1, 99, 99, "top", 8),
    ("a window chunk with a clamped tail", "sea", 3, 16, 100, 500, 8, 95, 99, "global", 2),
    ("a chunk of hyperplane rows, F = 1", "hyperplane", 1, 4, 64, 100, 3, 0, 10, "local", 2),
    ("drift_every 7, below a tile: 38 concepts a tile (prototypes)", "prototypes", 8, 16, 2000,
     7, 1, 9, 99, "global", 8),
    ("drift_every 7 (hyperplane_gradual)", "hyperplane_gradual", 10, 16, 2000, 7, 1, 9, 99,
     "global", 2),
    ("C·F past the staging budget: classes 4096 at F = 16", "prototypes", 16, 4, 1000, 100_000,
     1, 7, 99, "global", 4096),
    ("forced staging past its slots: classes 512, drift_every 18", "prototypes", 8, 4, 300, 18,
     1, 3, 99, "global", 512),
    ("B one row past a tile", "hyperplane", 10, 8, 257, 1000, 1, 3, 99, "global", 2),
]
# ROADMAP C8: the dirty CSV under quarantine through every hand kernel's
# path, at a cut depth
C8_RUNS = (("ph", dict(detector="ph")), ("hddm_w", dict(detector="hddm_w")),
           ("adwin", dict(detector="adwin")), ("mlp", dict(model="mlp")),
           ("forest", dict(model="forest")))
C8_MULT = 64
SOAK_KERNELS = ("soak_batch", "centroid_fit", "centroid_predict_err", "ddm_window")


def k6_feed(torch, soak, gen, f, p, b, de, count, t0, last, rows, dev, classes=8):
    """K6's inputs for a case: (keys, t0, count, last, row offsets,
    concept offsets, keyword arguments)."""
    from distributed_drift_detection_tpu_torch.engine.loop import device_keys
    from distributed_drift_detection_tpu_torch.utils import threefry

    keys = device_keys(threefry.split(threefry.key(p + b), p), dev)
    nb = last + 1 if rows != "local" else 100
    part = torch.arange(p, dtype=torch.int64, device=dev)
    if rows == "global":
        offs, block0s = part * nb * b, torch.zeros_like(part)
    elif rows == "local":
        offs, block0s = torch.zeros_like(part), part * 12_345
    else:
        offs, block0s = part * 0 + (2**31 - 1 - 100 * b), part * 3
    kw = dict(per_batch=b, features=f, drift_every=de, generator=gen)
    if gen == "prototypes":
        kw["classes"] = classes
    return keys, t0, count, last, offs.int().contiguous(), block0s.int().contiguous(), kw


def k6_equal(torch, soak, feed, what, force=0):
    got = soak.soak_batch(*feed[:6], force=force, **feed[6])
    want = soak.soak_batch_reference(*feed[:6], **feed[6])
    torch.cuda.synchronize()
    check(torch.equal(got.table.view(torch.int32), want.table.view(torch.int32))
          and torch.equal(got.labels, want.labels) and torch.equal(got.rows, want.rows),
          f"K6 differs from its plain version ({what}, force {force}, "
          f"{soak.soak_batch.plan.layout})")
    return got


def k6_ops(gen, f, c, p, b, count, t0, last, row_offs, block0s, de):
    """(f32 operations, 32-bit integer operations) K6's function needs for
    these inputs: a partition-batch's keys (fold_in and its splits); a
    row's own draws (sea 3 uniforms, hyperplane F uniforms and, gradual, F
    sines: glibc's sinf, 10 float64 operations at twice the f32 cost, prototypes randint's 2 hashes and
    its 4 modulos of ≈ 20 integer operations, and F normals) and its label;
    a concept's weights (F uniforms) or prototypes (C·F normals), with its
    fold_in, once for each concept a batch's rows reach."""
    key_hashes = {"sea": 1, "prototypes": 5}.get(gen, 2)
    rows = p * count * b
    if gen == "sea":
        row_hashes, row_int, row_f32 = 3, 0, 3 * (UNIFORM_F32_OPS + 1) + 1
    elif gen == "prototypes":
        row_hashes, row_int, row_f32 = 2 + f, 4 * 20, f * (ERFINV_F32_OPS + 1)
    else:
        row_hashes, row_int = f, 0
        row_f32 = f * (UNIFORM_F32_OPS + 2) + f + (f * 2 * 10 if gen == "hyperplane_gradual"
                                                      else 0)
    concepts = 0
    for q in range(p):
        for t in range(t0, t0 + count):
            t = min(t, last)
            lo = int(row_offs[q]) + t * b
            concepts += (lo + b - 1) // de - lo // de + 1
    per = {"sea": 0, "prototypes": c * f}.get(gen, f)
    per_f32 = ERFINV_F32_OPS + 1 if gen == "prototypes" else UNIFORM_F32_OPS
    hashes = p * count * key_hashes + rows * row_hashes + concepts * (1 + per)
    return (rows * row_f32 + concepts * per * per_f32,
            hashes * HASH_INT_OPS + rows * row_int)


# SHA-256 of K6's table, labels and row positions on the gradual batch at
# [128, 2000], F = 10, rows q·4100·2000 + 7·2000 (``k6_feed``), from the plain
# version on the CPU (glibc's sinf, as XLA's CPU sin)
K6_GRADUAL_DIGEST = "f0ad4baa101667386204240ff0b47767a50942091f4d4b24455f728a9cb98c86"


def k6_digest(out) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in (out.table, out.labels, out.rows):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def check_k6(torch, kernels, soak, dev):
    """K6 against its plain version on the card, bit for bit: each generator
    at the soak's [128, 2000] and K6_EDGES, each in the plan's layout and
    forced to each; times it on the prototypes batch (the soak's default),
    in each layout; returns its kernel row."""
    from distributed_drift_detection_tpu_torch.kernels import _build

    staged = 0
    for gen, f, _ in SOAK_GENS:
        feed = k6_feed(torch, soak, gen, f, SOAK_P, SOAK_B, SOAK_DE, 1, 7, 4099, "global", dev)
        for force in (0, 1, 2):
            k6_equal(torch, soak, feed, f"{gen} at [{SOAK_P}, {SOAK_B}], F = {f}", force)
            staged += soak.soak_batch.plan.slots > 0
    layouts = []
    for what, gen, f, p, b, de, count, t0, last, rows, c in K6_EDGES:
        feed = k6_feed(torch, soak, gen, f, p, b, de, count, t0, last, rows, dev, c)
        for force in (0, 1, 2):
            try:
                got = k6_equal(torch, soak, feed, what, force)
            except ValueError:
                plan = soak.k6_plan(p, count, b, f, gen, c, de, 1)
                check(force == 2 and 8 + 4 * plan.per_concept > soak.K6_MAX_SHARED,
                      f"K6 refused force {force} ({what})")
                continue
            plan = soak.soak_batch.plan
            if force == 0:
                layouts.append(f"{what}: {plan.layout} ({plan.slots} slots of {plan.span})")
            if count > 1:
                valid = t0 + torch.arange(count, device=dev) <= last
                check(bool(((got.rows >= 0) == valid[None, :, None]).all()),
                      f"K6: row positions of the clamped tail are not -1 ({what})")
    # the gradual batch's bits, pinned from the plain version (which holds
    # JAX's generator bit for bit: tests/test_torch_soak.py), re-pinned when
    # its sine became the C library's sinf
    gfeed = k6_feed(torch, soak, "hyperplane_gradual", 10, SOAK_P, SOAK_B, SOAK_DE, 1, 7, 4099,
                    "global", dev)
    gout = soak.soak_batch(*gfeed[:6], **gfeed[6])
    check(k6_digest(gout) == K6_GRADUAL_DIGEST,
          "K6: the gradual batch at [128, 2000] differs from its pinned digest")
    by_gen = {}
    for gen, f, _ in SOAK_GENS:
        feed = k6_feed(torch, soak, gen, f, SOAK_P, SOAK_B, SOAK_DE, 1, 7, 4099, "global", dev)
        out = soak.soak_batch(*feed[:6], **feed[6])
        by_gen[gen] = graph_ms(lambda feed=feed, out=out: soak.soak_batch(*feed[:6], out=out,
                                                                          **feed[6]))
    print(f"K6 soak_batch: the gradual batch equals its pinned digest; device ms by generator "
          f"at [{SOAK_P}, {SOAK_B}] (graphs of 50): "
          + ", ".join(f"{k} {v:.5f}" for k, v in by_gen.items()))
    print(f"K6 soak_batch: bit for bit its plain version at [{SOAK_P}, {SOAK_B}] for "
          + ", ".join(f"{g} (F = {f})" for g, f, _ in SOAK_GENS)
          + f" ({staged} of {3 * len(SOAK_GENS)} launches staged) and on "
          + "; ".join(layouts) + "; each also forced to each layout")

    gen, f, c = SOAK_GENS[0]
    feed = k6_feed(torch, soak, gen, f, SOAK_P, SOAK_B, SOAK_DE, 1, 7, 4099, "global", dev)
    keys, t0, count, last, offs, block0s, kw = feed
    out = soak.soak_batch(*feed[:6], **kw)
    plan = soak.soak_batch.plan
    by_layout = {}
    for force, name in ((0, "plan"), (1, "per-row"), (2, "staged")):
        by_layout[name] = graph_ms(
            lambda force=force: soak.soak_batch(*feed[:6], out=out, force=force, **kw))
    ms = by_layout["plan"]
    h_us = host_us(lambda: soak.soak_batch(*feed[:6], out=out, **kw))
    plain_ms = time_ms(lambda: soak.soak_batch_reference(*feed[:6], **kw), reps=3, rounds=3)
    floor = kernels.launcher("soak_batch_floor")
    floor_ms = graph_ms(lambda: kernels.check(
        "soak_batch_floor", floor(SOAK_P, 1, SOAK_B, kernels.stream_handle(dev))))
    n = SOAK_P * SOAK_B
    nbytes = n * (out.table.shape[1] * 4 + 4 + 4) + SOAK_P * 16
    f32_ops, int_ops = k6_ops(gen, f, c, SOAK_P, SOAK_B, 1, t0, last, offs.cpu(), block0s.cpu(),
                              SOAK_DE)
    b_ms, by = bound(nbytes, f32_ops, int_ops)
    sass = sass_hash_ops(str(_build.library_path("soak_batch")), "soak_tile_kernelILi3E")
    print(f"K6 soak_batch [{SOAK_P}, {SOAK_B}] prototypes F = {f}: {ms:.5f} ms device (graph "
          f"of 50; layout {plan.layout}, {plan.slots} slots, {plan.ctas} CTAs; per layout "
          + ", ".join(f"{k} {v:.5f}" for k, v in by_layout.items())
          + f"), {h_us:.1f} us host a call, {plain_ms:.4f} ms plain, bound {b_ms:.5f} ms ({by}: "
          f"{int_ops:,} integer operations at {INT32_OPS_PER_S / 1e12:.2f} T/s, {f32_ops:,} f32, "
          f"{nbytes:,} bytes), floor {floor_ms:.5f} ms (an empty kernel with its grid); "
          f"SASS (prototypes) {sass}")
    return dict(
        name="soak_batch", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/soak_gen.cu",
        replaces="distributed_drift_detection_tpu/engine/soak.py:113",
        max_abs_err=0.0, ms=ms, host_us=h_us, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=by, library_ms=None, floor_ms=floor_ms,
        ms_by_layout=by_layout, ms_by_generator=by_gen, sass=sass,
    )


def check_fit_at_2000(torch, classifiers, soak, dev):
    """K7 and K2 against their plain versions at the soak's per_batch 2000,
    on a K6 batch of 128 partitions: K7 bit for bit, K2's predictions equal
    off the near ties and its errors pred != y; both timed."""
    gen, f, c = SOAK_GENS[0]
    feed = k6_feed(torch, soak, gen, f, SOAK_P, SOAK_B, SOAK_DE, 1, 7, 4099, "global", dev)
    batch = soak.soak_batch(*feed[:6], **feed[6])
    X = batch.table.view(SOAK_P, SOAK_B, -1)[:, :, :f].contiguous()
    y = batch.labels.view(SOAK_P, SOAK_B).contiguous()
    w = torch.ones((SOAK_P, SOAK_B), dtype=torch.float32, device=dev)
    got = classifiers.centroid_fit(X, y, w, c)
    want = classifiers.centroid_fit_reference(X, y, w, c)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        check(torch.equal(g.view(torch.int32), r.view(torch.int32)),
              "K7 differs from its plain version at per_batch 2000")
    idx = torch.arange(SOAK_P * SOAK_B, dtype=torch.int32, device=dev).view(SOAK_P, SOAK_B)
    T = classifiers.pad_row_table(batch.table[:, :f])
    err, pred = classifiers.centroid_predict_err(got.centroids, got.bias, T, batch.labels, idx,
                                                 return_pred=True)
    _, rpred = classifiers.centroid_predict_err_reference(got.centroids, got.bias, T,
                                                          batch.labels, idx)
    scores = torch.bmm(X.double(), got.centroids.double().transpose(1, 2)) + got.bias.double()[:, None]
    top2 = scores.topk(2, -1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 1e-4 * (1 + top2[..., 0].abs())
    check(torch.equal(pred[~tie], rpred[~tie]), "K2 differs off the near ties at per_batch 2000")
    check(torch.equal(err, (pred != y).float()), "K2 errors are not pred != y at per_batch 2000")
    k7_ms = time_ms(lambda: classifiers.centroid_fit(X, y, w, c))
    k2_ms = time_ms(lambda: classifiers.centroid_predict_err(got.centroids, got.bias, T,
                                                             batch.labels, idx))
    print(f"K7 at [{SOAK_P}, {SOAK_B}] F = {f} C = {c}: bit for bit its plain version, "
          f"{k7_ms:.5f} ms a call (events, wrapper included); K2 there: predictions equal off "
          f"{int(tie.sum())} near ties, errors pred != y, {k2_ms:.5f} ms a call")
    return {"K7 [128, 2000] F=8 C=8": k7_ms, "K2 [128, 2000] F=8 C=8": k2_ms}


def soak_flags_equal(np_, a, b) -> bool:
    return all(np_.array_equal(np_.asarray(getattr(a, f).cpu()), np_.asarray(getattr(b, f).cpu()))
               for f in a._fields)


def soak_cut(torch, soak, build_model, ModelSpec, threefry, dev):
    """(c) the soak at the cut depth on the card against the port's CPU run,
    flags leaf by leaf: each generator, the window engine, and a chain with
    its checkpoint; (d) the chain killed at ``soak.leg`` and resumed.
    Returns the card's uninterrupted chain summary."""
    import os
    import tempfile

    from distributed_drift_detection_tpu_torch.resilience import faults

    runs = [(gen, f, c, {}) for gen, f, c in SOAK_GENS]
    runs.append(SOAK_GENS[0] + (dict(window=SOAK_CUT_WINDOW),))
    for gen, f, c, kw in runs:
        model = build_model("centroid", ModelSpec(f, c))
        t0 = time.perf_counter()
        ref = soak.make_soak_runner(model, generator=gen, device="cpu", **SOAK_CUT, **kw)(
            threefry.key(0))
        cpu_s = time.perf_counter() - t0
        reset_launches()
        got = soak.make_soak_runner(model, generator=gen, device=dev, **SOAK_CUT, **kw)(
            threefry.key(0))
        torch.cuda.synchronize()
        sl = read_launches()
        check(soak_flags_equal(np, ref.flags, got.flags),
              f"soak {gen} {kw}: the card's flags differ from the CPU's")
        check(sl["soak_batch"] > 0 and sl["centroid_fit"] > 0 and sl["ddm_window"] > 0,
              f"soak {gen} {kw}: K6, K7 or K1 not launched")
        det = int((got.flags.change_global >= 0).sum())
        print(f"soak {gen} {kw or 'window=1'} at {SOAK_CUT}: flags equal to the CPU run "
              f"({cpu_s:.1f} s there), {det} detections; launches "
              f"{ {k: v for k, v in sl.items() if v} }")

    model = build_model("centroid", ModelSpec(8, 8))
    tmp = tempfile.TemporaryDirectory()
    ckpt = os.path.join(tmp.name, "chain.ckpt")

    def legs_of(out):
        return lambda s, flags: out.append(np.asarray(flags.change_global))

    cpu_legs, card_legs = [], []
    cpu = soak.run_soak_chained(model, device="cpu", on_leg=legs_of(cpu_legs), **SOAK_CHAIN)
    reset_launches()
    card = soak.run_soak_chained(model, device=dev, checkpoint_path=ckpt,
                                 on_leg=legs_of(card_legs), **SOAK_CHAIN)
    cl = read_launches()
    check(card.legs == cpu.legs >= 2 and card.detections == cpu.detections
          and np.array_equal(card.delays, cpu.delays)
          and all(np.array_equal(a, b) for a, b in zip(card_legs, cpu_legs)),
          "chained soak: the card's legs differ from the CPU's")
    check(not os.path.exists(ckpt), "chained soak: the checkpoint outlived the chain")
    print(f"chained soak {SOAK_CHAIN} with a checkpoint: {card.legs} legs, "
          f"{card.detections} detections of {card.planted_boundaries} planted, each leg's "
          f"change_global equal to the CPU run's; launches { {k: v for k, v in cl.items() if v} }")

    os.environ["DDD_FAULTS"] = "soak.leg:at=2"
    try:
        faults.arm_from_env()
        try:
            soak.run_soak_chained(model, device=dev, checkpoint_path=ckpt, **SOAK_CHAIN)
        except faults.InjectedFault:
            pass
        else:
            fail("DDD_FAULTS=soak.leg did not kill the chain")
    finally:
        del os.environ["DDD_FAULTS"]
        faults.disarm_all()
    check(os.path.exists(ckpt), "the killed chain left no checkpoint")
    resumed_legs = []
    resumed = soak.run_soak_chained(model, device=dev, checkpoint_path=ckpt,
                                    on_leg=lambda s, fl: resumed_legs.append(s), **SOAK_CHAIN)
    check(resumed.detections == card.detections and np.array_equal(resumed.delays, card.delays)
          and resumed_legs == list(range(1, card.legs)) and not os.path.exists(ckpt),
          "the resumed chain does not give the uninterrupted summary")
    print(f"chain killed by DDD_FAULTS=soak.leg:at=2 before leg 1, resumed from its checkpoint "
          f"at leg 1: legs {resumed_legs} run, summary equal to the uninterrupted chain's")
    tmp.cleanup()
    return card


def soak_phase(torch, api, config, kernels, classifiers, res, dev):
    """Phase 17 (module docstring): returns K6's kernel row, K7's and K2's
    per_batch-2000 times and the 1e9-row soak's numbers."""
    import os
    import tempfile

    from distributed_drift_detection_tpu_torch.engine import soak
    from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model
    from distributed_drift_detection_tpu_torch.utils import threefry
    from distributed_drift_detection_tpu_torch.utils.timing import trace_files

    t_phase = time.perf_counter()
    # (a) K6, (b) K7 and K2 at per_batch 2000
    row = check_k6(torch, kernels, soak, dev)
    fit_ms = check_fit_at_2000(torch, classifiers, soak, dev)
    # (c), (d) the cut depth against the CPU, kill and resume
    soak_cut(torch, soak, build_model, ModelSpec, threefry, dev)

    # (e) the 1e9-row soak at bench.py's geometry: a 2-leg chain, then the
    # one-shot runner on the chain's rows; per-partition positions equal
    model = build_model("centroid", ModelSpec(8, 8))
    chain_pos = [[] for _ in range(SOAK_P)]

    def collect(leg, flags):
        cg = np.asarray(flags.change_global)
        for q in range(SOAK_P):
            hit = cg[q][cg[q] >= 0]
            if hit.size:
                chain_pos[q].append(hit.astype(np.int64))

    s = soak.run_soak_chained(model, partitions=SOAK_P, per_batch=SOAK_B,
                              drift_every=SOAK_DE, total_rows=SOAK_ROWS,
                              max_leg_rows=SOAK_LEG_ROWS, on_leg=collect, device=dev)
    nb = s.rows_processed // (SOAK_P * SOAK_B)
    check(s.legs == 2 and SOAK_P * nb * SOAK_B <= 2**31 - 1,
          f"the chain ran {s.legs} legs of {nb} batches")
    run = soak.make_soak_runner(model, partitions=SOAK_P, per_batch=SOAK_B,
                                num_batches=nb, drift_every=SOAK_DE, device=dev)
    key = threefry.key(0)
    run(key).flags.change_global.cpu()  # the first run pays the first launches
    reset_launches()
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        out = run(key)
        cg = out.flags.change_global.cpu().numpy()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = read_launches()
    rows = out.rows_processed
    for k in SOAK_KERNELS:
        check(launches[k] > 0, f"1e9 soak: kernel {k} was not launched")
    detections = int((cg >= 0).sum())
    same = s.detections == detections
    for q in range(SOAK_P):
        one = np.sort(cg[q][cg[q] >= 0].astype(np.int64) - q * nb * SOAK_B)
        ch = np.sort(np.concatenate(chain_pos[q])) if chain_pos[q] else np.empty(0, np.int64)
        same = same and np.array_equal(one, ch)
    check(same, "the 2-leg chain's per-partition detection positions differ from the one-shot's")
    planted = soak.planted_interior_boundaries(SOAK_P, nb * SOAK_B, SOAK_DE)
    delays = cg[cg >= 0].astype(np.int64) % SOAK_DE
    median = statistics.median(times)
    check(detections == planted, f"1e9 soak: {detections} detections, {planted} planted")
    card_line = card()
    print(f"soak of {rows:,} rows ({SOAK_P} partitions x {nb} batches x {SOAK_B}, prototypes, "
          f"centroid (8, 8), DDM) on {card_line}: the 2-leg chain (max_leg_rows 2^29, "
          f"{s.exec_time_s:.3f} s) and the one-shot found the same {detections} detections at "
          f"the same per-partition positions; planted interior boundaries {planted}; median "
          f"delay {statistics.median(delays.tolist()) if delays.size else float('nan')} rows; "
          f"one-shot {median:.4f} s (median of 3 warm runs: "
          + ", ".join(f"{t:.4f}" for t in times) + f"), {rows / median:,.0f} rows/s; launches "
          f"{ {k: launches[k] for k in SOAK_KERNELS} }")
    row["launches"] = launches["soak_batch"]

    # one traced step window: 50 steps of the same geometry
    short = soak.make_soak_runner(model, partitions=SOAK_P, per_batch=SOAK_B, num_batches=51,
                                  drift_every=SOAK_DE, device=dev)
    short(key).flags.change_global.cpu()
    kern, window_s = traced(torch, lambda: short(key).flags.change_global.cpu())
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    per = {}
    for name in SOAK_KERNELS:
        hits = kernel_hits(kern, name)
        count = sum(e.count for e in hits)
        check(count > 0, f"the soak's traced window saw no {name} launch")
        per[name] = (count, sum(e.self_device_time_total for e in hits) / count)
    row["in_run_launches"], row["in_run_us"] = per["soak_batch"]
    idle = 1.0 - busy / window_s
    print(f"soak traced window (50 steps): {sum(e.count for e in kern)} kernels busy "
          f"{busy:.4f} s of {window_s:.4f} s, idle share {idle:.3f}; "
          + ", ".join(f"{k} {c} x {us:.2f} us" for k, (c, us) in per.items()))

    # (g) SMOKE with validate=True, a profile_dir and a trace_dir: phase 4's
    # flags; each trace names K1, K2 and K7
    tmp = tempfile.TemporaryDirectory()
    base = config.RunConfig(**SMOKE)
    for field, value in (("validate", True), ("profile_dir", os.path.join(tmp.name, "prof")),
                         ("trace_dir", os.path.join(tmp.name, "trace"))):
        vres = api.run(config.replace(base, **{field: value}), device=dev)
        check(flags_equal(np, vres, res), f"{field}: flags differ from phase 4's run")
        what = f"{field}={value!r}: phase 4's flags, Final Time {vres.total_time:.4f} s"
        if field != "validate":
            files = trace_files(value)
            check(len(files) == 1, f"{field}: {len(files)} trace files")
            with open(files[0]) as fh:
                text = fh.read()
            names = ("ddm_window", "centroid_predict_err", "centroid_fit")
            missing = [k for k in names if KERNEL_SYMBOLS[k] not in text]
            check(not missing, f"{field}: the trace names no {missing}")
            what += (f"; {os.path.basename(files[0])} in {os.path.basename(os.path.dirname(files[0]))}"
                     f", {os.path.getsize(files[0]):,} bytes, names K1, K2 and K7")
        print(what)
    tmp.cleanup()
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return row, fit_ms, dict(rows=rows, seconds=median, rows_per_s=rows / median,
                             idle_share=idle)


# Phase 18: K13's cases (B places a batch: every path's edges — the warp
# path's 32-place floor and its last B, 1024, the CTA path's one-round edge
# 1625, its step from 16 composites a thread to 32 (4096, 4097) and its
# last B, 16384, the global path above; P partitions; W = 1
# with a key a batch, the loop engine's, and W = 128 with keys split W
# ways, the window engine's), the shapes it is timed at, the chunked path's
# geometry and the cut depth of the shuffled runs.
K13_BS = (1, 2, 16, 17, 32, 33, 100, 1024, 1025, 1625, 1626, 2000, 4096, 4097, 16384, 16385,
          20000)
K13_P = 16
K13_TIE_BS = (17, 100, 1025, 1626, 4097)  # forced ties: warp and CTA paths, 1 and 2 rounds
K13_TIMED = ((16, 128, 100), (16, 8, 100), (16, 1, 100))  # window 128, window 8, window=1
CHUNK_BATCHES = 256
SHUFFLE_MULT, SHUFFLE_CB = 64, 32
TENANTS = 4


def k13_planes(torch, p, nb, b, idx_dtype, dev, seed):
    """Random planes ``[p, nb, b]`` made on ``dev`` from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, 30000, (p, nb, b), generator=g, device=dev).to(idx_dtype)
    rows = torch.randint(-1, 2**31 - 1, (p, nb, b), generator=g, device=dev).to(torch.int32)
    valid = torch.rand((p, nb, b), generator=g, device=dev) < 0.8
    return idx, rows, valid


def k13_keys(torch, shape, dev, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(dev)


def k13_equal(torch, shuffle, args, kw, what):
    got = shuffle.shuffle_planes(*args, **kw)
    ref = shuffle.shuffle_planes_reference(*args, **{k: v for k, v in kw.items() if k != "force"})
    for g, r in zip(got, ref):
        check(g.dtype == r.dtype and bool(torch.equal(g, r)),
              f"K13 differs from its plain version ({what})")


def k13_int_ops(p, w, b):
    """32-bit integer operations of K13's work, whatever its algorithm: a
    threefry hash (``HASH_INT_OPS``) for each draw and for each round's key
    split and the batch's key, and ⌈log2 B⌉ compares a place a round (what
    any comparison sort of B places needs)."""
    from distributed_drift_detection_tpu_torch.utils import threefry

    rounds = threefry.permutation_rounds(b)
    hashes = p * w * (rounds * (b + 2) + 1)
    return HASH_INT_OPS * hashes + p * w * rounds * b * max(1, math.ceil(math.log2(b)))


def k13_kernel_layout(kernels, b, force):
    """The layout K13's library takes for batches of ``b`` places
    (``shuffle_perm_path``), as ``ops/shuffle.py`` ``k13_layout`` names it."""
    import ctypes

    from distributed_drift_detection_tpu_torch.ops import shuffle

    out = (ctypes.c_int * 6)()
    kernels.check("shuffle_perm_path", kernels.launcher("shuffle_perm_path")(b, force, out))
    lay = dict(zip(("path", "npow2", "per_thread", "threads", "warps", "shared_bytes"), out))
    lay["path"] = shuffle.K13_PATHS[lay["path"]]
    return lay


def k13_timed(torch, kernels, shuffle, p, w, b, dev):
    """K13 at [p, w, b] with derived keys and each lane's start (a chunk's
    256 batches and the window's pad as the source): device ms (graph of
    50), floor ms, host µs and bound."""
    from distributed_drift_detection_tpu_torch.utils import threefry

    nb = CHUNK_BATCHES + w
    idx, rows, valid = k13_planes(torch, p, nb, b, torch.int32, dev, 1)
    keys = k13_keys(torch, (p, 2), dev, 3)
    start = torch.randint(0, CHUNK_BATCHES, (p,), device=dev)
    outs = [torch.empty((p, w, b), dtype=dt, device=dev)
            for dt in (torch.int32, torch.int32, torch.bool)]
    fn = kernels.launcher("shuffle_perm")
    rounds = threefry.permutation_rounds(b)

    def launch():
        kernels.check("shuffle_perm", fn(
            keys.data_ptr(), 1, p, w, idx.data_ptr(), 4, rows.data_ptr(), valid.data_ptr(),
            start.data_ptr(), nb, b, rounds, 0xFFFFFFFF, 0,
            *(o.data_ptr() for o in outs), None, kernels.stream_handle(dev)))

    floor = kernels.launcher("shuffle_perm_floor")
    n = p * w * b
    nbytes = n * (4 + 4 + 1) * 2 + p * (8 + 8)  # planes read and written, keys, starts
    int_ops = k13_int_ops(p, w, b)
    b_ms, by = bound(nbytes, 0, int_ops)
    return dict(
        shape=[p, w, b], ms=graph_ms(launch),
        floor_ms=graph_ms(lambda: kernels.check(
            "shuffle_perm_floor", floor(p, w, b, 0, kernels.stream_handle(dev)))),
        host_us=host_us(lambda: shuffle.shuffle_planes(keys, idx, rows, valid, w, start)),
        bound_ms=b_ms, bound_by=by, nbytes=nbytes, int_ops=int_ops,
        planes=(keys, idx, rows, valid, start))


def check_k13(torch, kernels, dev):
    """K13 against its plain version on the card, bit for bit, at every B
    of ``K13_BS`` (each path's edges), W = 1 and 128, int16 and int32 index
    planes, on a grid of P = 3, W = 5 (15 batches: not a multiple of the
    warp path's batches a CTA), with its draws forced to tie (on the warp
    and CTA paths and forced to the global one); the library's own layout
    against ``k13_layout`` at every B and at ``force`` 1; then timed at
    ``K13_TIMED`` (each with its floor and bound). Returns its row."""
    from distributed_drift_detection_tpu_torch.ops import shuffle

    t0 = time.perf_counter()
    cases = 0
    for b in K13_BS:
        for force in (0, 1):
            check(k13_kernel_layout(kernels, b, force) == shuffle.k13_layout(b, force),
                  f"K13's layout at B={b}, force {force} differs from k13_layout")
        for w, derive in ((1, False), (128, True)):
            for dt in (torch.int16, torch.int32):
                nb = w + 5
                planes = k13_planes(torch, K13_P, nb, b, dt, dev, b + w)
                keys = k13_keys(torch, (K13_P, 2) if derive else (K13_P, w, 2), dev, b)
                start = torch.randint(0, 6, (K13_P,), device=dev) if derive else None
                k13_equal(torch, shuffle, (keys, *planes, w, start), dict(derive=derive),
                          f"B={b} W={w} {dt}")
                cases += 1
    for b in (17, 100, 1025):
        planes = k13_planes(torch, 3, 9, b, torch.int16, dev, b)
        k13_equal(torch, shuffle, (k13_keys(torch, (3, 2), dev, b), *planes, 5,
                                   torch.tensor([0, 4, 2], device=dev)), {}, f"P=3 W=5 B={b}")
        cases += 1
    for b in K13_TIE_BS:
        planes = k13_planes(torch, K13_P, 130, b, torch.int32, dev, 7)
        keys = k13_keys(torch, (K13_P, 2), dev, 11)
        for force in (0, 1):
            k13_equal(torch, shuffle, (keys, *planes, 128, None),
                      dict(tie_mask=0x3, force=force), f"ties at B={b}, force {force}")
            cases += 1
    print(f"K13 shuffle_perm: bit for bit its plain version in {cases} launches: B = "
          + ", ".join(map(str, K13_BS)) + f" (P = {K13_P}, W = 1 and 128, int16 and int32 "
          "index planes; paths " + ", ".join(
              f"{b}: {shuffle.k13_layout(b)['path']}" for b in (1024, 1025, 16384, 16385))
          + "), P = 3 W = 5 at B = 17, 100, 1025, and draws forced to tie (mask 0x3, B = "
          + ", ".join(map(str, K13_TIE_BS)) + ", on its own path and forced to the global "
          f"one); the library's layout equals k13_layout at every B and force "
          f"({time.perf_counter() - t0:.1f} s)")

    timed = [k13_timed(torch, kernels, shuffle, p, w, b, dev) for p, w, b in K13_TIMED]
    main = timed[0]
    p, w, b = main["shape"]
    keys, idx, rows, valid, start = main["planes"]
    plain_ms = time_ms(lambda: shuffle.shuffle_planes_reference(keys, idx, rows, valid, w, start),
                       reps=3, rounds=3)
    draws = torch.randint(0, 2**32, (p * w, b), device=dev, dtype=torch.int64)
    lib_ms = time_ms(lambda: torch.sort(draws, dim=-1, stable=True))
    lay = shuffle.k13_layout(b)
    print(f"K13 shuffle_perm [{p}, {w}, {b}] (derived keys, each lane's start): {main['ms']:.5f} "
          f"ms device (graph of 50; {lay['path']} path, {lay['warps']} batches a CTA, "
          f"{lay['threads']} threads, {lay['per_thread']} composites a lane, "
          f"{lay['shared_bytes']} shared bytes, {-(-p * w // lay['warps'])} CTAs), "
          f"{main['host_us']:.1f} us host a call, {plain_ms:.4f} ms plain, bound "
          f"{main['bound_ms']:.5f} ms ({main['bound_by']}: {main['int_ops']:,} integer operations "
          f"at {INT32_OPS_PER_S / 1e12:.2f} T/s, {main['nbytes']:,} bytes), library {lib_ms:.5f} "
          f"ms (torch.sort(stable=True) of the [{p * w}, {b}] int64 draws: the sort only), floor "
          f"{main['floor_ms']:.5f} ms (an empty kernel with its grid)")
    for t in timed:
        print(f"K13 shuffle_perm {t['shape']}: {t['ms']:.5f} ms device, floor {t['floor_ms']:.5f} "
              f"ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}), {t['host_us']:.1f} us host a "
              "call")
    return dict(
        name="shuffle_perm", route="cuda",
        source="distributed_drift_detection_tpu_torch/csrc/shuffle_perm.cu",
        replaces="distributed_drift_detection_tpu/engine/window.py:211",
        max_abs_err=0.0, ms=main["ms"], host_us=main["host_us"], plain_ms=plain_ms,
        bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=lib_ms,
        library="torch.sort(stable=True), the sort only", floor_ms=main["floor_ms"],
        layout=lay,
        by_shape=[{k: t[k] for k in ("shape", "ms", "floor_ms", "host_us", "bound_ms")}
                  for t in timed],
    )


def float32_text(v) -> str:
    """A decimal that strtod, then a cast to float32, parses back to the
    float32 ``v`` (the native parser's path): the shortest float32
    repr when it does, else the float64 repr, exact."""
    s = np.format_float_positional(np.float32(v), unique=True, trim="-")
    return s if np.float32(float(s)) == np.float32(v) else repr(float(v))


def write_stream_csv(stream, path: str) -> int:
    """The synthesized stream's rows, in stream order, in the reference's
    CSV schema: every row one of the row table's, its text built once."""
    base = [",".join(float32_text(v) for v in row) + f",{int(lab)}"
            for row, lab in zip(stream.base_X, stream.base_y)]
    f = stream.base_X.shape[1]
    with open(path, "w") as fh:
        fh.write(",".join([*map(str, range(f)), "target"]) + "\n")
        fh.write("\n".join(base[i] for i in stream.src.tolist()) + "\n")
    return os.path.getsize(path)


def chunked_phase(torch, api, config, kernels, cfg, res, dev):
    """Phase 18 (module docstring): returns K13's kernel row."""
    import contextlib
    import io
    import tempfile

    from distributed_drift_detection_tpu_torch.engine.chunked import ChunkedDetector
    from distributed_drift_detection_tpu_torch.harness import chunked_cli
    from distributed_drift_detection_tpu_torch.io import feeder
    from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model
    from distributed_drift_detection_tpu_torch.ops import shuffle
    from distributed_drift_detection_tpu_torch.telemetry.metrics import MetricsRegistry

    t_phase = time.perf_counter()
    # (a) K13 against its plain version, timed
    row = check_k13(torch, kernels, dev)

    # (b) the chunked path at full width from the stream's CSV
    tmp = tempfile.TemporaryDirectory()
    csv_path = f"{tmp.name}/stream.csv"
    t0 = time.perf_counter()
    nbytes = write_stream_csv(res.stream, csv_path)
    print(f"stream CSV: {res.stream.num_rows} rows, {nbytes:,} bytes, written in "
          f"{time.perf_counter() - t0:.1f} s")
    f, c = res.stream.num_features, res.stream.num_classes
    p, b = cfg.partitions, cfg.per_batch
    ccfg = config.replace(cfg, window=128, window_rotations=4)
    for workers in (1, 4):
        det, info = api.prepare_chunked(config.replace(ccfg, ingest_workers=workers), f, c,
                                        chunk_batches=CHUNK_BATCHES, device=dev)
        reg = MetricsRegistry()
        reset_launches()
        t0 = time.perf_counter()
        chunks = feeder.prefetch_chunks(feeder.csv_chunks(
            csv_path, p, b, CHUNK_BATCHES, shuffle_seed=config.host_shuffle_seed(cfg),
            workers=feeder.resolve_ingest_workers(workers), metrics=reg), metrics=reg)
        flags = det.run(chunks, metrics=reg)
        span = time.perf_counter() - t0
        launches = read_launches()
        detections = int((flags.change_global >= 0).sum())
        check(detections == EXPECTED_DETECTIONS,
              f"chunked ({workers} workers): {detections} detections")
        for name in res.flags._fields:
            check(np.array_equal(getattr(flags, name), getattr(res.flags, name)),
                  f"chunked ({workers} workers): flags.{name} differ from phase 4's run")
        for k in ("ddm_window", "centroid_predict_err", "centroid_fit"):
            check(launches[k] > 0, f"chunked: kernel {k} was not launched")
        rows_in = int(reg.counter("ingest_rows_total").values[()])
        print(f"chunked on the card ({workers} ingest workers, W=128 R=4, {CHUNK_BATCHES} "
              f"batches a chunk): {detections} detections, flags equal to phase 4's run; "
              f"{rows_in} rows in {span:.3f} s end to end (parse included), "
              f"{rows_in / span:,.0f} rows/s; prepare {info['aot_seconds']:.3f} s; stages "
              f"{feeder.stage_breakdown(reg)}; launches {launches}")
    cli = {}
    for workers in ("1", "4"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            chunked_cli.main([csv_path, "--classes", str(c), "--partitions", str(p),
                              "--per-batch", str(b), "--chunk-batches", str(CHUNK_BATCHES),
                              "--window", "128", "--ingest-workers", workers],
                             device=str(dev))
        cli[workers] = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(cli[workers]["detections"] == EXPECTED_DETECTIONS,
              f"chunked CLI ({workers} workers): {cli[workers]['detections']} detections")
    print("chunked CLI on the card: " + "; ".join(
        f"{w} workers: detections {o['detections']}, rows {o['rows']}, chunks {o['chunks']}, "
        f"{o['rows_per_sec']:,.0f} rows/s, stages {o['pipeline_s']}" for w, o in cli.items()))
    tmp.cleanup()

    # (c) shuffle=True on the card at a cut depth, against the CPU
    scfg = config.replace(cfg, mult_data=SHUFFLE_MULT)
    stream = api._load_stream_for(scfg)
    model = build_model("centroid", ModelSpec(f, c))

    def shuffled(device, **kw):
        det = ChunkedDetector(model, partitions=p, shuffle=True, device=device, **kw)
        chunks = list(feeder.chunk_stream_arrays(stream.X, stream.y, p, b, SHUFFLE_CB))
        return det, chunks

    full = {}
    for name, kw in (("window=1", dict(window=1)), ("window=8 R=2", dict(window=8, rotations=2))):
        cdet, chunks = shuffled("cpu", **kw)
        want = cdet.run(chunks)
        det, chunks = shuffled(dev, **kw)
        reset_launches()
        got = det.run(chunks)
        launches = read_launches()
        for fld in want._fields:
            check(np.array_equal(getattr(got, fld), getattr(want, fld)),
                  f"shuffled {name}: flags.{fld} differ between the card and the CPU")
        check(launches["shuffle_perm"] > 0, f"shuffled {name}: K13 was not launched")
        full[name] = (got, launches["shuffle_perm"])
        print(f"shuffle=True chunked {name} (mult_data {SHUFFLE_MULT}, {SHUFFLE_CB} batches a "
              f"chunk) on the card: {int((got.change_global >= 0).sum())} detections, flags "
              f"equal to the CPU run; launches {launches} (K13 on its "
              f"{shuffle.k13_layout(b)['path']} path)")
    row["launches"] = full["window=8 R=2"][1]
    det, chunks = shuffled(dev, window=8, rotations=2)
    it = iter(chunks)
    det.feed(next(it))
    kern, _ = traced(torch, lambda: det.feed(next(it)))
    hits = kernel_hits(kern, "shuffle_perm")
    count = sum(e.count for e in hits)
    check(count > 0, "the profiler saw no K13 launch in a shuffled chunk")
    row["in_run_launches"] = count
    row["in_run_us"] = sum(e.self_device_time_total for e in hits) / count
    print(f"K13 in a shuffled chunk (window 8, R = 2): {count} launches x "
          f"{row['in_run_us']:.2f} us")

    # (d) a checkpoint mid-stream
    ckpt = f"{tempfile.mkdtemp()}/chunked.ckpt"
    a, chunks = shuffled(dev, window=8, rotations=2)
    head = [a.feed(ch) for ch in chunks[:2]]
    a.save(ckpt)
    b_det, _ = shuffled(dev, window=8, rotations=2)
    b_det.restore(ckpt, example_chunk=chunks[0])
    tail = [b_det.feed(ch) for ch in chunks[2:]]
    want = full["window=8 R=2"][0]
    for i, fld in enumerate(want._fields):
        got = np.concatenate([fl[i].cpu().numpy() for fl in head + tail], 1)
        check(np.array_equal(got, getattr(want, fld)),
              f"resumed chunked run: flags.{fld} differ from the uninterrupted run")
    os.remove(ckpt)
    print("checkpoint after chunk 2, restored into a fresh detector: the remaining flags "
          "equal the uninterrupted run's")

    # (e) the tenant plane: run_multi of TENANTS tenants at SMOKE
    reset_launches()
    mr = api.run_multi(config.replace(cfg, tenants=TENANTS), device=dev)
    ml = read_launches()
    for k in ("ddm_window", "centroid_predict_err", "centroid_fit"):
        check(ml[k] > 0, f"run_multi: kernel {k} was not launched")
    for t, r in enumerate(mr.results):
        solo = res if t == 0 else api.run(config.replace(cfg, seed=t), device=dev)
        for fld in r.flags._fields:
            check(np.array_equal(getattr(r.flags, fld), getattr(solo.flags, fld)),
                  f"run_multi: tenant {t}'s flags.{fld} differ from its solo run")
        check(np.array_equal(r.drift_vote, solo.drift_vote), f"run_multi: tenant {t}'s vote")
        v = r.drift_vote
        print(f"tenant {t} of {TENANTS} on the card: {r.metrics.num_detections} detections, "
              f"mean delay {r.metrics.mean_delay_rows:.4f} rows, vote max {v.max():.4f} at "
              f"{int((v > 0.5).sum())} steps above 0.5; flags and vote equal to its solo run"
              + (" (phase 4's)" if t == 0 else ""))
    print(f"run_multi ({TENANTS} tenants at SMOKE, one stacked run): Final Time "
          f"{mr.total_time:.4f} s, {mr.agg_rows_per_sec:,.0f} rows/s over {mr.rows} rows; "
          f"launches {ml}")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return row


# Phase 19: the serving daemon on the card. A replay ends with the loadgen's
# FLUSH, so the linger deadline is long enough that no seal splits a replay
# (the chunks are then the stripe of the whole stream, as phase 18's are).
SERVE_LINGER_S = 30.0
SERVE_SHALLOW_CB = 32  # batches a chunk at SHALLOW_MULT: 5 chunks of 51,200 rows
SERVE_DIRTY = ("nan_cell:6:3", "bad_label:4:4")
SERVE_STAGES = ("admission", "queue", "device", "collect", "total")


def table_from_verdicts(records, partitions):
    """The ``change_global`` table a verdict sidecar describes."""
    total = max(r["flag_base"] + r["cols"] for r in records)
    cg = np.full((partitions, total), -1, np.int64)
    for r in records:
        for p, b, pos in r["changes"]:
            cg[p, r["flag_base"] + b] = pos
    return cg


def served_equal(got, ref, what):
    """Served flags equal batch flags field by field; the served columns past
    the batch run's width (a short last chunk's padding) are sentinels."""
    w = ref.change_global.shape[1]
    for fld in ref._fields:
        check(np.array_equal(np.asarray(getattr(got, fld))[:, :w], getattr(ref, fld)),
              f"{what}: flags.{fld} differ")
    check(bool(np.all(np.asarray(got.change_global)[:, w:] == -1)), f"{what}: padding flagged")


def ms(seconds) -> str:
    return "none" if seconds is None else f"{seconds * 1e3:.2f}"


def serve_in_main(runner, client):
    """Run ``client`` on a thread while the serve loop runs on this one (the
    thread of ``runner.start()``: only it launches kernels); ``client`` ends
    with ``runner.request_stop()``. Returns (loop exit code, client output,
    drain seconds from the stop request to the loop's return)."""
    import threading

    out = {}

    def body():
        try:
            client(out)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e
        finally:
            out["t_stop"] = time.perf_counter()
            runner.request_stop()

    th = threading.Thread(target=body)
    th.start()
    code = runner.serve_forever()
    drain = time.perf_counter() - out["t_stop"]
    th.join()
    if "error" in out:
        raise out["error"]
    return code, out, drain


def admit_spans(admissions, streams, lo, hi, span):
    """Admit rows ``[lo, hi)`` of each tenant's stream as v2 frames, a span
    a tenant in turn (balanced seals)."""
    for base in range(lo, hi, span):
        for adm, (X, y) in zip(admissions, streams):
            e = min(base + span, hi)
            adm.admit_frame(X[base:e], y[base:e])


def serve_phase(torch, api, config, cfg, res, rows, main_launches, dev):
    """Phase 19 (module docstring): the serving daemon on the card."""
    import glob
    import signal
    import socket
    import tempfile
    import urllib.request

    from distributed_drift_detection_tpu_torch.config import ServeParams
    from distributed_drift_detection_tpu_torch.io.sanitize import read_quarantine
    from distributed_drift_detection_tpu_torch.io.stream import StreamData
    from distributed_drift_detection_tpu_torch.parallel.mesh import split_tenant_flags
    from distributed_drift_detection_tpu_torch.resilience import faults
    from distributed_drift_detection_tpu_torch.serve import ServeRunner, loadgen, read_verdicts
    from distributed_drift_detection_tpu_torch.telemetry import registry
    from distributed_drift_detection_tpu_torch.telemetry.trace import hist_quantile

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    scfg = config.replace(cfg, window=128, window_rotations=4)
    X, y = np.ascontiguousarray(res.stream.X), np.ascontiguousarray(res.stream.y, np.int32)
    n, f, c = len(y), res.stream.num_features, res.stream.num_classes
    p = cfg.partitions

    def params(**kw):
        kw.setdefault("port", None)
        kw.setdefault("chunk_batches", CHUNK_BATCHES)
        kw.setdefault("linger_s", SERVE_LINGER_S)
        return ServeParams(num_features=f, num_classes=c, **kw)

    # (a) the full replay over loopback as wire v2 frames
    d = f"{tmp.name}/a"
    runner = ServeRunner(config.replace(scfg, telemetry_dir=d), params(port=0, ops_port=0),
                         keep_flags=True, device=dev)
    t0 = time.perf_counter()
    banner = runner.start()
    start_s = time.perf_counter() - t0

    def replay(out):
        out["t_wall"] = time.time()
        out["report"] = loadgen.run_loadgen(
            banner["host"], banner["port"], None, verdicts=banner["verdicts"], timeout=600,
            wire_version="v2", arrays=(X, y), frame_rows=4096)
        base = f"http://{banner['host']}:{banner['ops_port']}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            out["healthz"] = r.status
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            out["metrics"] = r.read().decode()

    reset_launches()
    code, out, drain_s = serve_in_main(runner, replay)
    sl = read_launches()
    rep = out["report"]
    check(code == 0, f"serve (a): the loop returned {code}")
    check(rep["rows_covered"] == n and not rep["timeout"],
          f"serve (a): {rep['rows_covered']} of {n} rows covered (timeout {rep['timeout']})")
    check(runner._detections == EXPECTED_DETECTIONS,
          f"serve (a): {runner._detections} detections, expected {EXPECTED_DETECTIONS}")
    recs = read_verdicts(banner["verdicts"])
    served_cg = table_from_verdicts(recs, p)
    check(np.array_equal(served_cg, res.flags.change_global),
          "serve (a): the change_global table of the verdict sidecar differs from phase 4's")
    served_equal(runner.flags(), res.flags, "serve (a) against phase 4's run")
    bundles = glob.glob(os.path.splitext(banner["run_log"])[0] + ".forensics/drift-*.json")
    check(len(bundles) == EXPECTED_DETECTIONS,
          f"serve (a): {len(bundles)} forensics bundles for {EXPECTED_DETECTIONS} verdicts")
    check(out["healthz"] == 200, f"serve (a): /healthz answered {out['healthz']}")
    check("serve_row_latency_seconds_bucket" in out["metrics"],
          "serve (a): /metrics lacks serve_row_latency_seconds_bucket")
    for k in ("ddm_window", "centroid_predict_err", "centroid_fit"):
        check(sl[k] > 0, f"serve (a): kernel {k} was not launched while serving")
    check(sl["shuffle_perm"] == 0 and main_launches["shuffle_perm"] == 0,
          "K13 launched on the main path or the serving path (both stripe on the host)")
    k13 = next(r for r in rows if r["name"] == "shuffle_perm")
    k13["main_path_launches"], k13["serve_launches"] = main_launches["shuffle_perm"], sl["shuffle_perm"]
    served_s = max(r["ts"] for r in recs) - out["t_wall"]
    lat = {s: (hist_quantile(runner._lat_hist, 0.5, stage=s),
               hist_quantile(runner._lat_hist, 0.99, stage=s)) for s in SERVE_STAGES}
    print(f"serve (a) on the card ({card()}): {n} rows as v2 frames over loopback, "
          f"{runner._published} chunks of {CHUNK_BATCHES} batches, W=128 R=4: "
          f"{runner._detections} detections; the sidecar's change_global and the kept flags "
          f"equal phase 4's; {len(bundles)} forensics bundles; /healthz 200; launches {sl}")
    print(f"serve (a): start (prepare) {start_s:.3f} s; admission {rep['achieved_rows_per_sec']:,.0f} "
          f"rows/s (the client's send); served {n / served_s:,.0f} rows/s (first row sent to "
          f"the last verdict, {served_s:.3f} s); row->verdict p50/p99 ms by stage "
          + ", ".join(f"{s} {ms(a)}/{ms(b)}" for s, (a, b) in lat.items())
          + f"; the client's p50/p99 {rep['p50_ms']}/{rep['p99_ms']} ms; "
          f"serve_stage_busy_seconds_total {dict((k, round(v, 4)) for k, v in sorted(runner._stage_clock.busy.items()))}; "
          f"drain {drain_s:.3f} s")

    # (e)'s daemon (the serve CLI on the card as a process) starts now, so
    # its start-up overlaps (b)-(d)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    m = [sys.executable, "-m", "distributed_drift_detection_tpu_torch"]
    tele = f"{tmp.name}/e"
    t_spawn = time.perf_counter()
    proc = subprocess.Popen(
        m + ["serve", "--features", str(f), "--classes", str(c), "--partitions", str(p),
             "--per-batch", str(cfg.per_batch), "--chunk-batches", "2", "--window", "8",
             "--port", "0", "--ops-port", "0", "--linger-s", "600", "--telemetry-dir", tele,
             *(["--device", str(dev)] if dev.type != "cuda" else [])],
        stdout=subprocess.PIPE, env=env, text=True, cwd=root)
    try:
        # (b) dirty rows over v1 text at SHALLOW_MULT under quarantine
        bcfg = config.replace(scfg, mult_data=SHALLOW_MULT, data_policy="quarantine")
        bstream = api._load_stream_for(config.replace(cfg, mult_data=SHALLOW_MULT))
        t0 = time.perf_counter()
        lines = loadgen.format_lines(bstream.X, bstream.y)
        bad = sorted({r for spec in SERVE_DIRTY for r, _ in loadgen.apply_dirty(lines, spec)})
        fmt_s = time.perf_counter() - t0
        runner = ServeRunner(config.replace(bcfg, telemetry_dir=f"{tmp.name}/b"),
                             params(port=0, chunk_batches=SERVE_SHALLOW_CB), keep_flags=True,
                             device=dev)
        banner = runner.start()

        def replay_v1(out):
            out["report"] = loadgen.run_loadgen(banner["host"], banner["port"], lines,
                                                verdicts=banner["verdicts"], timeout=600)

        reset_launches()
        code, out, _ = serve_in_main(runner, replay_v1)
        bl = read_launches()
        check(code == 0 and out["report"]["rows_covered"] == len(lines),
              f"serve (b): exit {code}, {out['report']['rows_covered']} rows covered")
        ok = np.ones(len(lines), bool)
        ok[bad] = False
        masked = StreamData(X=bstream.X, y=bstream.y, num_classes=bstream.num_classes,
                            dist_between_changes=bstream.dist_between_changes, row_ok=ok)
        ref = api.run(bcfg, stream=masked, device=dev)
        served_equal(runner.flags(), ref.flags, "serve (b) against api.run with the rows masked")
        check(ref.metrics.num_detections > 0, "serve (b): no detections to compare")
        q = read_quarantine(os.path.splitext(banner["run_log"])[0] + ".quarantine.jsonl")
        check(sorted(r["row"] for r in q) == bad,
              "serve (b): the quarantine sidecar does not name exactly the corrupted rows")
        for k in ("ddm_window", "centroid_predict_err", "centroid_fit"):
            check(bl[k] > 0, f"serve (b): kernel {k} was not launched")
        print(f"serve (b): {len(lines)} rows as v1 text (formatted in {fmt_s:.1f} s) with "
              f"{', '.join(SERVE_DIRTY)}: {runner._detections} detections, flags equal to api.run "
              f"on the card with the {len(bad)} rows masked ({ref.metrics.num_detections} "
              f"detections); the sidecar names exactly those rows; admission "
              f"{out['report']['achieved_rows_per_sec']:,.0f} rows/s")

        # (c) kill at chunk 2 (serve.flush raises), resume from the checkpoint
        ckpt = f"{tmp.name}/serve.ckpt"
        frames = 1 << 16
        ccfg = config.replace(scfg, telemetry_dir=f"{tmp.name}/c")
        r1 = ServeRunner(ccfg, params(checkpoint=ckpt, checkpoint_every=1), keep_flags=True,
                         device=dev)
        r1.start()
        admit_spans([r1.admission], [(X, y)], 0, n, frames)
        r1.batcher.flush()
        r1.request_stop()
        faults.arm("serve.flush", at=3)
        try:
            r1.serve_forever()
            fail("serve (c): the armed serve.flush fault did not fire")
        except faults.InjectedFault:
            pass
        finally:
            faults.disarm_all()
        check(r1._published == 2 and os.path.exists(ckpt),
              f"serve (c): {r1._published} chunks published before the fault")
        r2 = ServeRunner(ccfg, params(checkpoint=ckpt, checkpoint_every=1), keep_flags=True,
                         device=dev)
        b2 = r2.start()
        start = int(r2.resumed_meta["rows_admitted"])
        check(b2["resumed"] and start == 2 * p * CHUNK_BATCHES * cfg.per_batch,
              f"serve (c): resumed {b2['resumed']} at row {start}")
        admit_spans([r2.admission], [(X, y)], start, n, frames)
        r2.batcher.flush()
        r2.request_stop()
        check(r2.serve_forever() == 0, "serve (c): the resumed loop failed")
        union = read_verdicts(r1.verdicts_path) + read_verdicts(r2.verdicts_path)
        check(np.array_equal(table_from_verdicts(union, p), served_cg),
              "serve (c): the killed and resumed verdicts differ from (a)'s uninterrupted run")
        f1, f2 = r1.flags(), r2.flags()
        served_equal(type(f1)(*(np.concatenate([a, b], 1) for a, b in zip(f1, f2))), res.flags,
                     "serve (c) against phase 4's run")
        print(f"serve (c): serve.flush raised at chunk 2 after 2 published chunks; a fresh daemon "
              f"resumed at row {start}; the union of the verdicts equals (a)'s and phase 4's flags")

        # (d) TENANTS slots at SHALLOW_MULT against solo daemons; SAVETENANT of
        # slot 1 mid-stream, LOADTENANT into a fresh daemon
        tcfg = config.replace(scfg, mult_data=SHALLOW_MULT, tenants=TENANTS)
        tstreams = []
        for tc in config.tenant_configs(tcfg):
            s = api._load_stream_for(tc)
            tstreams.append((np.ascontiguousarray(s.X), np.ascontiguousarray(s.y, np.int32)))
        tn = len(tstreams[0][1])
        span = p * SERVE_SHALLOW_CB * cfg.per_batch
        tparams = params(chunk_batches=SERVE_SHALLOW_CB)
        plane = ServeRunner(tcfg, tparams, keep_flags=True, device=dev)
        plane.start()
        admit_spans(plane.admissions, tstreams, 0, tn, span)
        plane.batcher.flush()
        plane.request_stop()
        reset_launches()
        check(plane.serve_forever() == 0, "serve (d): the tenant plane's loop failed")
        dl = read_launches()
        per = split_tenant_flags(plane.flags(), TENANTS)
        dets = []
        for t, tc in enumerate(config.tenant_configs(tcfg)):
            solo = ServeRunner(config.replace(tc, tenants=1), tparams, keep_flags=True, device=dev)
            solo.start()
            admit_spans([solo.admission], [tstreams[t]], 0, tn, span)
            solo.batcher.flush()
            solo.request_stop()
            check(solo.serve_forever() == 0, f"serve (d): tenant {t}'s solo daemon failed")
            for fld in per[t]._fields:
                check(np.array_equal(getattr(per[t], fld), getattr(solo.flags(), fld)),
                      f"serve (d): slot {t}'s flags.{fld} differ from its solo daemon's")
            dets.append(solo._detections)
            check(solo._detections > 0, f"serve (d): tenant {t}'s solo daemon detected nothing")
        ckpt_t = f"{tmp.name}/slot1.ckpt"
        cut = 2 * span
        a = ServeRunner(tcfg, tparams, device=dev)
        a.start()
        admit_spans(a.admissions, tstreams, 0, cut, span)
        replies = []
        a.request_control("SAVETENANT", 1, ckpt_t, replies.append)
        a.request_stop()
        check(a.serve_forever() == 0 and replies == [f"OK SAVETENANT 1 {cut}"],
              f"serve (d): SAVETENANT answered {replies}")
        bplane = ServeRunner(tcfg, tparams, keep_flags=True, device=dev)
        bplane.start()

        def land(out):
            got = []
            bplane.request_control("LOADTENANT", 1, ckpt_t, got.append)
            deadline = time.monotonic() + 120
            while not got and time.monotonic() < deadline:
                time.sleep(0.01)
            out["reply"] = got
            admit_spans(bplane.admissions, tstreams, cut, tn, span)
            bplane.batcher.flush()

        code, out, _ = serve_in_main(bplane, land)
        check(code == 0 and out["reply"] == [f"OK LOADTENANT 1 {cut}"],
              f"serve (d): LOADTENANT answered {out['reply']}")
        landed = split_tenant_flags(bplane.flags(), TENANTS)[1]
        col = 2 * SERVE_SHALLOW_CB - 1  # the first chunk's first batch seeds batch_a
        for fld in landed._fields:
            check(np.array_equal(getattr(landed, fld), getattr(per[1], fld)[:, col:]),
                  f"serve (d): the landed tenant's flags.{fld} differ from its uninterrupted slot")
        for k in ("ddm_window", "centroid_predict_err", "centroid_fit"):
            check(dl[k] > 0, f"serve (d): kernel {k} was not launched")
        print(f"serve (d): {TENANTS} slots at mult_data {SHALLOW_MULT}: each slot's flags equal "
              f"its solo daemon's (detections {dets}); SAVETENANT of slot 1 after {cut} rows, "
              f"LOADTENANT into a fresh {TENANTS}-slot daemon: its flags continue bit for bit")

        # (e) fed by the loadgen CLI, then seven rows without FLUSH, then
        # SIGTERM
        eb = json.loads(proc.stdout.readline())
        up_s = time.perf_counter() - t_spawn
        lg = subprocess.run(
            m + ["loadgen", SMOKE["dataset"], "--port", str(eb["port"]), "--wire", "v2",
                 "--dir", tele, "--timeout", "120"],
            capture_output=True, text=True, env=env, cwd=root, timeout=300)
        check(lg.returncode == 0, f"serve (e): loadgen exited {lg.returncode}: {lg.stderr[-2000:]}")
        lrep = json.loads(lg.stdout.strip().splitlines()[-1])
        sent = lrep["rows_sent"]
        check(lrep["rows_covered"] == sent, f"serve (e): {lrep['rows_covered']} of {sent} covered")
        extra = loadgen.format_lines(X[:7], y[:7])
        with socket.create_connection((eb["host"], eb["port"]), timeout=30) as sock:
            sock.sendall(("\n".join(extra) + "\n").encode())
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with urllib.request.urlopen(f"http://{eb['host']}:{eb['ops_port']}/statusz",
                                        timeout=30) as r:
                if json.loads(r.read())["rows"]["admitted"] == sent + 7:
                    break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 0, f"serve (e): the daemon exited {rc} on SIGTERM")
    last = read_verdicts(eb["verdicts"])[-1]
    check(last["rows_through"] == sent + 7 and last["short"],
          f"serve (e): the drain published through row {last['rows_through']}, not {sent + 7}")
    runs = registry.runs(tele)
    check([r["status"] for r in runs.values() if r.get("kind") == "serve"] == ["completed"],
          f"serve (e): registry {[r['status'] for r in runs.values()]}")
    print(f"serve (e): `serve` on the card spawned before (b), its banner read {up_s:.1f} s "
          f"later; the loadgen CLI covered {sent} "
          f"rows (p50/p99 {lrep['p50_ms']}/{lrep['p99_ms']} ms); 7 rows without FLUSH; "
          f"SIGTERM: exit 0, the partial microbatch published (rows_through "
          f"{last['rows_through']}, short), the registry completed")
    tmp.cleanup()
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return {"records": recs, "rows_per_s": n / served_s}


# Phase 20: drift adaptation (A13) and the tenant router (A12b).
# (a) SMOKE served with a refit of ADAPT_WINDOW post-drift rows after each
# drift verdict (K7 at [1, 12800, 21], the pair scorer K2 at [2·16, 12800]);
# (b) a shadow plane at SHALLOW_MULT whose stream holds a promotion and a
# demotion (8 batches a chunk: a chunk's span is the window); (c) FLEET_TENANTS
# tenants over two daemons behind the router, each daemon a process on the
# card with FLEET_SPARES vacant slots, the replay cut at FLEET_CUTS: a
# graceful migration after the first cut, a daemon killed after the second.
ADAPT_WINDOW = 12_800
ADAPT_SPEC = f"retrain,window_rows={ADAPT_WINDOW}"
SHADOW_CB = 8
SHADOW_SPEC = "shadow,window_rows=12800,margin=0.0"
FLEET_TENANTS, FLEET_SPARES, FLEET_CB, FLEET_WINDOW = 4, 2, 32, 8
# a tenant's dealt share of the SHALLOW_MULT stream is 64,000 rows, 1,600 a
# concept: 4 partitions of 25 rows a batch see 16 batches of each concept
FLEET_PARTITIONS, FLEET_PER_BATCH = 4, 25
FLEET_CUTS = (0.4, 0.7)
FLEET_INTERLEAVE = 64  # loadgen's dealing: round-robin blocks of 64 rows
_ADAPT_KEYS = ("tenant", "trigger_chunk", "policy", "rows_refit", "err_before", "err_after",
               "promoted", "applied_chunk", "rows_to_apply", "pre_drift_err", "window_rows",
               "demoted")


def adaptation_events(log_path):
    """A run log's ``adaptation`` events, but for times and ids."""
    from distributed_drift_detection_tpu_torch.telemetry.events import read_events

    return [{k: e.get(k) for k in _ADAPT_KEYS} for e in read_events(log_path)
            if e["type"] == "adaptation"]


def verdict_rows(records):
    """A verdict sidecar but for its wall clocks."""
    return [{k: v for k, v in r.items() if k not in ("ts", "lat_ms")} for r in records]


def deal(n_rows, tenants, interleave=FLEET_INTERLEAVE):
    """loadgen's dealing of a replay: each tenant's row indices."""
    streams = [[] for _ in range(tenants)]
    for base in range(0, n_rows, interleave):
        streams[(base // interleave) % tenants].extend(
            range(base, min(base + interleave, n_rows)))
    return streams


def tenant_entries(paths, gid):
    """Global tenant ``gid``'s verdict entries across a fleet's sidecars,
    in rows_through order."""
    from distributed_drift_detection_tpu_torch.serve import read_verdicts

    out = []
    for path in paths:
        if path and os.path.exists(path):
            out += [e for r in read_verdicts(path) for e in r.get("tenants") or []
                    if int(e.get("id", e["tenant"])) == gid and e["rows"]]
    return sorted(out, key=lambda e: int(e["rows_through"]))


def entries_equal(got, ref, what):
    check(len(got) == len(ref), f"{what}: {len(got)} verdict entries, the solo daemon's {len(ref)}")
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in ("rows", "rows_through", "start_row", "detections"):
            check(int(g[k]) == int(r[k]), f"{what}: entry {i} {k} {g[k]} != {r[k]}")
        check([tuple(x) for x in g["changes"]] == [tuple(x) for x in r["changes"]],
              f"{what}: entry {i}'s changes differ")


def adapt_phase(torch, api, config, kernels, classifiers, cfg, p19, dev):
    """Phase 20 (module docstring): drift adaptation and the tenant router.
    Returns the window-shape times of K7 and K2 ({"K7": ms, "K2": ms})."""
    import tempfile

    from distributed_drift_detection_tpu_torch.config import ServeParams
    from distributed_drift_detection_tpu_torch.serve import ServeRunner, loadgen, read_verdicts

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    scfg = config.replace(cfg, window=128, window_rotations=4)
    stream = api._load_stream_for(cfg)
    X, y = np.ascontiguousarray(stream.X), np.ascontiguousarray(stream.y, np.int32)
    n, f, c, p = len(y), stream.num_features, stream.num_classes, cfg.partitions
    on_card = dev.type == "cuda"

    def params(**kw):
        kw.setdefault("port", None)
        kw.setdefault("chunk_batches", CHUNK_BATCHES)
        kw.setdefault("linger_s", SERVE_LINGER_S)
        return ServeParams(num_features=f, num_classes=c, **kw)

    # (a) the full replay as v2 frames with a refit after each drift verdict
    runner = ServeRunner(config.replace(scfg, telemetry_dir=f"{tmp.name}/a"),
                         params(port=0, ops_port=0, on_drift=(ADAPT_SPEC,)),
                         keep_flags=True, device=dev)
    banner = runner.start()
    ctl = runner._adapt
    fits, adapt_launches = [], {"centroid_fit": 0, "centroid_predict_err": 0}
    fit_window, on_chunk = ctl._fit_window, ctl.on_chunk

    def recording_fit(key, Xw, yw, ww):
        out = fit_window(key, Xw, yw, ww)
        fits.append((Xw.copy(), yw.copy(), ww.copy(), out.centroids[0].clone(),
                     out.bias[0].clone()))
        return out

    def counting_on_chunk(meta, flags, chunk):
        before = read_launches()
        on_chunk(meta, flags, chunk)
        after = read_launches()
        for k in adapt_launches:
            adapt_launches[k] += after[k] - before[k]

    ctl._fit_window, ctl.on_chunk = recording_fit, counting_on_chunk

    def replay(out):
        out["t_wall"] = time.time()
        out["report"] = loadgen.run_loadgen(
            banner["host"], banner["port"], None, verdicts=banner["verdicts"], timeout=600,
            wire_version="v2", arrays=(X, y), frame_rows=4096)

    reset_launches()
    code, out, _ = serve_in_main(runner, replay)
    al = read_launches()
    rep = out["report"]
    check(code == 0 and rep["rows_covered"] == n and not rep["timeout"],
          f"adapt (a): exit {code}, {rep['rows_covered']} of {n} rows covered")
    events = adaptation_events(banner["run_log"])
    applied = [e for e in events if e["promoted"]]
    check(bool(applied), "adapt (a): no adaptation was applied")
    check(all(e["policy"] == "retrain" and e["rows_refit"] == ADAPT_WINDOW for e in applied),
          "adapt (a): an applied refit is not a full retrain window")
    prom = runner._metrics.to_prometheus_text()
    counted = sum(float(line.rsplit(" ", 1)[1]) for line in prom.splitlines()
                  if line.startswith("adaptations_total{"))
    check(counted == len(events) == ctl.snapshot()["adaptations"],
          f"adapt (a): adaptations_total {counted}, {len(events)} events, snapshot "
          f"{ctl.snapshot()['adaptations']}")
    check(len(fits) == len(events), f"adapt (a): {len(fits)} refits for {len(events)} events")
    # each refit's K7 output against the plain version's fit of its window,
    # on the same device, the windows stacked as partitions
    Xw, yw, ww = (torch.from_numpy(np.stack([fit[i] for fit in fits])).to(dev) for i in range(3))
    ref = classifiers.centroid_fit_reference(Xw, yw, ww, c)
    got_c = torch.stack([fit[3] for fit in fits])
    got_b = torch.stack([fit[4] for fit in fits])
    check(torch.equal(got_c.view(torch.int32), ref.centroids.view(torch.int32))
          and torch.equal(got_b.view(torch.int32), ref.bias.view(torch.int32)),
          "adapt (a): a refit's K7 output differs from the plain version's fit of its window")
    # the counters count launches on the card only (the CPU runs the plain
    # versions)
    check(not on_card or (adapt_launches["centroid_fit"] >= len(fits)
                          and adapt_launches["centroid_predict_err"] >= len(fits)),
          f"adapt (a): the adaptation's own launches {adapt_launches} for {len(fits)} refits")
    for k in ("ddm_window", "centroid_predict_err", "centroid_fit"):
        check(not on_card or al[k] > 0, f"adapt (a): kernel {k} was not launched while serving")
    recs = read_verdicts(banner["verdicts"])
    first = min(e["applied_chunk"] for e in applied)
    if p19 is not None:
        mine = [r for r in verdict_rows(recs) if r["chunk"] <= first]
        theirs = [r for r in verdict_rows(p19["records"]) if r["chunk"] <= first]
        check(mine == theirs, f"adapt (a): the verdicts through chunk {first} (the first "
              "applied adaptation) differ from phase 19's")
    served_s = max(r["ts"] for r in recs) - out["t_wall"]
    busy = runner._stage_clock.busy
    times = {"K7": None, "K2": None}
    if on_card:
        # K7 at the window's shape [1, 12800, F] and the pair scorer's K2 at
        # [2·P, 12800]: one launch each, graphs of 50
        fn7 = kernels.launcher("centroid_fit")
        X1, y1, w1 = (t[:1].contiguous() for t in (Xw, yw, ww))
        cent = torch.empty((1, c, f), dtype=torch.float32, device=dev)
        bias = torch.empty((1, c), dtype=torch.float32, device=dev)
        a7 = classifiers.centroid_fit_args(X1, y1, w1, cent, bias)
        times["K7"] = graph_ms(lambda: kernels.check("centroid_fit",
                                                     fn7(*a7, kernels.stream_handle(dev))))
        cent2 = cent.expand(2 * p, c, f).contiguous()
        bias2 = bias.expand(2 * p, c).contiguous()
        T = classifiers.pad_row_table(X1[0])
        idx = torch.arange(ADAPT_WINDOW, dtype=torch.int32, device=dev).expand(
            2 * p, ADAPT_WINDOW).contiguous()
        err = torch.empty(idx.shape, dtype=torch.float32, device=dev)
        a2 = classifiers.centroid_predict_err_args(cent2, bias2, T, y1[0], idx, err)
        fn2 = kernels.launcher("centroid_predict_err")
        times["K2"] = graph_ms(lambda: kernels.check("centroid_predict_err",
                                                     fn2(*a2, kernels.stream_handle(dev))))
        b7, by7 = bound(ADAPT_WINDOW * (f + 2) * 4 + c * (f + 1) * 4,
                        ADAPT_WINDOW * (f + 1) + 2 * c * f)
        rows2 = 2 * p * ADAPT_WINDOW
        b2, by2 = bound(rows2 * 8 + ADAPT_WINDOW * (T.shape[1] + 1) * 4 + 2 * p * c * (f + 1) * 4,
                        rows2 * c * 2 * f)
        print(f"adapt (a) kernels at the window's shape ({card()}): K7 centroid_fit "
              f"[1, {ADAPT_WINDOW}, {f}] {times['K7'] * 1e3:.2f} us a launch (bound "
              f"{b7 * 1e3:.3f} us, {by7}); K2 centroid_predict_err [{2 * p}, {ADAPT_WINDOW}] "
              f"{times['K2'] * 1e3:.2f} us a launch (bound {b2 * 1e3:.3f} us, {by2}); graphs of 50")
        # the keyed refits' kernels take a window's B too: K9 (the mlp) and
        # K11 (the forest) on the first window, against their plain versions
        from distributed_drift_detection_tpu_torch.engine.loop import device_keys
        from distributed_drift_detection_tpu_torch.models import forest, mlp
        from distributed_drift_detection_tpu_torch.utils import threefry

        wkey = device_keys(threefry.key(7)[None], dev)
        dims = (f, 128, 64, c)
        check_k9_close(torch, mlp, wkey, (X1, y1, w1), dims, K9_TIGHT_STEPS, 0.05,
                       f"a window [1, {ADAPT_WINDOW}]")
        cs9, ws9 = mlp.k9_launch_plan(dev, dims, ADAPT_WINDOW, 1)
        t9 = time_ms(lambda: mlp.mlp_fit(wkey, X1, y1, w1, dims, 32, 0.05), reps=10, rounds=3)
        got = forest.forest_fit(wkey, X1, y1, w1, 32, 3, c)
        want = forest.forest_fit_reference(wkey, X1, y1, w1, 32, 3, c)
        check(all(torch.equal(g, r) for g, r in zip(got, want)),
              "K11 differs from its plain version at the window's shape")
        plan11 = forest.k11_plan(ADAPT_WINDOW, f, c, 32, 3)
        t11 = time_ms(lambda: forest.forest_fit(wkey, X1, y1, w1, 32, 3, c), reps=10, rounds=3)
        print(f"adapt (a): at a window's B = {ADAPT_WINDOW}, K9 (mlp {dims}) within rtol "
              f"{K9_RTOL} / atol {K9_TIGHT_ATOL} of its plain version after {K9_TIGHT_STEPS} "
              f"steps ({cs9} CTA(s) a partition, workspace {'global' if ws9 else 'shared'}), "
              f"{t9 * 1e3:.1f} us a 32-step fit; K11 (32 trees of depth 3) bit for bit its "
              f"plain version (layout {plan11._asdict()}), {t11 * 1e3:.1f} us a fit; each "
              "with its allocations, CUDA events around 10 calls")
    rate = n / served_s
    print(f"adapt (a) on the card ({card()}): SMOKE served as v2 frames with --on-drift "
          f"{ADAPT_SPEC}: {len(applied)} adaptations applied of {len(events)} decisions "
          f"(adaptations_total {counted:.0f}), every refit's K7 output bit for bit the plain "
          f"version's fit of its window; {runner._detections} detections; the verdicts through "
          f"chunk {first} equal phase 19's; the adaptation's own launches {adapt_launches}; "
          f"the adapt stage busy {busy.get('adapt', 0.0):.4f} s of "
          f"{sum(busy.values()):.4f} s; served {rate:,.0f} rows/s"
          + (f" (phase 19: {p19['rows_per_s']:,.0f})" if p19 else "")
          + f"; recovery {ctl.recovery_rows()} rows")

    # (b) shadow at SHALLOW_MULT: the card's daemon against the port's CPU
    # daemon on the same stream
    bcfg = config.replace(scfg, mult_data=SHALLOW_MULT)
    bstream = api._load_stream_for(config.replace(cfg, mult_data=SHALLOW_MULT))
    bX, by = np.ascontiguousarray(bstream.X), np.ascontiguousarray(bstream.y, np.int32)
    got = {}
    for where in (dev, torch.device("cpu")):
        r = ServeRunner(config.replace(bcfg, telemetry_dir=f"{tmp.name}/b_{where.type}"),
                        params(chunk_batches=SHADOW_CB, on_drift=(SHADOW_SPEC,)),
                        keep_flags=True, device=where)
        r.start()
        admit_spans([r.admission], [(bX, by)], 0, len(by), 1 << 16)
        r.batcher.flush()
        r.request_stop()
        check(r.serve_forever() == 0, f"adapt (b): the {where.type} daemon failed")
        got[where.type] = (verdict_rows(read_verdicts(r.verdicts_path)),
                           adaptation_events(r._log.path), r._adapt.recovery_rows(),
                           r._detections)
    card_b, cpu_b = got[dev.type], got["cpu"]
    check(card_b[0] == cpu_b[0], "adapt (b): the served verdicts differ from the CPU daemon's")
    check(card_b[1] == cpu_b[1], "adapt (b): the adaptation events differ from the CPU daemon's")
    check(card_b[2] == cpu_b[2], f"adapt (b): recovery {card_b[2]} rows, the CPU's {cpu_b[2]}")
    check(any(e["promoted"] for e in card_b[1]) and any(e["demoted"] for e in card_b[1]),
          f"adapt (b): no promotion and demotion in the stream: {card_b[1]}")
    print(f"adapt (b): {SHADOW_SPEC} at mult_data {SHALLOW_MULT}, {SHADOW_CB} batches a chunk: "
          f"{sum(1 for e in card_b[1] if e['promoted'])} promotion(s), "
          f"{sum(1 for e in card_b[1] if e['demoted'])} demotion(s), recovery {card_b[2]} rows, "
          f"{card_b[3]} detections; verdicts, adaptation events and recovery equal to the "
          "port's CPU daemon")

    # (c) the fleet: two daemons (processes) behind the router
    fleet_phase_20(torch, config, cfg, tmp.name, bX, by, f, c, dev)
    tmp.cleanup()
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return times


def fleet_phase_20(torch, config, cfg, tmp, X, y, f, c, dev):
    """Phase 20 (c): FLEET_TENANTS tenants over two serve processes placed
    by plan_fleet, fed by loadgen --router over v2 in three cuts; a graceful
    migration after the first, a kill after the second."""
    import json as _json
    import signal

    from distributed_drift_detection_tpu_torch.config import ServeParams
    from distributed_drift_detection_tpu_torch.serve import ServeRunner, loadgen
    from distributed_drift_detection_tpu_torch.serve.router import (
        BackendSpec,
        TenantRouter,
        plan_fleet,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    m = [sys.executable, "-m", "distributed_drift_detection_tpu_torch"]
    p, b = FLEET_PARTITIONS, FLEET_PER_BATCH
    assign = plan_fleet(FLEET_TENANTS, ["A", "B"], spares=FLEET_SPARES)
    procs, banners = {}, {}
    t_spawn = time.perf_counter()
    try:
        for name, ids in assign.items():
            procs[name] = subprocess.Popen(
                m + ["serve", "--features", str(f), "--classes", str(c), "--partitions", str(p),
                     "--per-batch", str(b), "--chunk-batches", str(FLEET_CB), "--window",
                     str(FLEET_WINDOW), "--tenants", str(len(ids)), "--tenant-ids",
                     ",".join(map(str, ids)), "--name", name, "--port", "0", "--ops-port", "0",
                     "--linger-s", str(SERVE_LINGER_S), "--telemetry-dir", f"{tmp}/tele{name}",
                     "--checkpoint", f"{tmp}/{name}.ckpt", "--tenant-checkpoints",
                     *(["--device", str(dev)] if dev.type != "cuda" else [])],
                stdout=subprocess.PIPE, env=env, text=True, cwd=root)
        for name, proc in procs.items():
            banners[name] = _json.loads(proc.stdout.readline())
        up_s = time.perf_counter() - t_spawn
        specs = [BackendSpec(f"127.0.0.1:{banners[k]['port']}:{banners[k]['ops_port']}")
                 for k in ("A", "B")]
        router = TenantRouter(specs, telemetry_dir=f"{tmp}/teleR", health_interval_s=0.5,
                              health_fails=2, ops_port=0)
        rb = router.start()
        dirs = [f"{tmp}/teleA", f"{tmp}/teleB"]
        cuts = [0, *(int(len(y) * q) for q in FLEET_CUTS), len(y)]
        reports = []

        def replay(k, stop=False):
            t0 = time.time()
            r = loadgen.run_loadgen(rb["host"], rb["port"], None, rate=0.0, timeout=600,
                                    stop=stop, tenants=FLEET_TENANTS, wire_version="v2",
                                    arrays=(X[cuts[k]:cuts[k + 1]], y[cuts[k]:cuts[k + 1]]),
                                    fleet_dirs=dirs)
            check(not r["timeout"] and r["rows_covered"] == r["rows_sent"],
                  f"fleet (c): cut {k}: {r['rows_covered']} of {r['rows_sent']} rows covered")
            r["served_rows_per_s"] = r["rows_sent"] / (time.time() - t0)
            reports.append(r)

        replay(0)
        g_mig = assign["A"][0]
        t0 = time.perf_counter()
        check(router.migrate_tenant(g_mig, "B"), f"fleet (c): migrating tenant {g_mig} failed")
        pause_s = time.perf_counter() - t0
        replay(1)
        g_fo = assign["A"][1]
        t_kill = time.perf_counter()
        procs["A"].send_signal(signal.SIGKILL)
        procs["A"].wait(timeout=60)
        deadline = time.monotonic() + 120
        while True:
            st = router.status()
            place = st["placements"][str(g_fo)]
            if place["state"] == "active" and place["backend"] == "B":
                break
            check(time.monotonic() < deadline, f"fleet (c): tenant {g_fo} never failed over: {st}")
            time.sleep(0.05)
        failover_s = time.perf_counter() - t_kill
        replay(2, stop=True)
        check(procs["B"].wait(timeout=300) == 0, "fleet (c): daemon B did not drain on STOP")
        status = router.status()
        router.stop()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(status["migrations"] == 1 and status["failovers"] >= 1 and status["rows_lost"] == 0,
          f"fleet (c): migrations {status['migrations']}, failovers {status['failovers']}, "
          f"rows lost {status['rows_lost']}")
    journal = [_json.loads(line) for line in open(f"{tmp}/teleR/router.journal.jsonl")]
    fo = [e for e in journal if e["event"] == "failover"]
    check(bool(fo) and all(int(e.get("lost_rows", 0)) == 0 for e in fo),
          f"fleet (c): the journal's failovers {fo}")
    # each tenant against the unmoved plane: one daemon of FLEET_TENANTS slots
    # (tenant g in slot g, its solo identity), fed the same three cuts by
    # run_loadgen over loopback without the router (its rows/s the router's
    # yardstick)
    plane = ServeRunner(config.RunConfig(partitions=p, per_batch=b, tenants=FLEET_TENANTS,
                                         window=FLEET_WINDOW, seed=0, results_csv="",
                                         telemetry_dir=f"{tmp}/teleRef"),
                        ServeParams(num_features=f, num_classes=c, port=0,
                                    chunk_batches=FLEET_CB, linger_s=SERVE_LINGER_S),
                        device=dev)
    pb = plane.start()

    def direct(out):
        out["rates"] = []
        for k in range(3):
            t0 = time.time()
            r = loadgen.run_loadgen(pb["host"], pb["port"], None, rate=0.0, timeout=600,
                                    tenants=FLEET_TENANTS, wire_version="v2",
                                    arrays=(X[cuts[k]:cuts[k + 1]], y[cuts[k]:cuts[k + 1]]),
                                    verdicts=pb["verdicts"])
            check(not r["timeout"] and r["rows_covered"] == r["rows_sent"],
                  f"fleet (c): the unmoved plane covered {r['rows_covered']} of {r['rows_sent']}")
            out["rates"].append((r["achieved_rows_per_sec"], r["rows_sent"] / (time.time() - t0)))

    code, out, _ = serve_in_main(plane, direct)
    check(code == 0, "fleet (c): the unmoved plane failed")
    sidecars = glob_verdicts(f"{tmp}/teleA") + glob_verdicts(f"{tmp}/teleB")
    dets = []
    for g in range(FLEET_TENANTS):
        ref = tenant_entries([plane.verdicts_path], g)
        got = tenant_entries(sidecars, g)
        entries_equal(got, ref, f"fleet (c): tenant {g}")
        sent = sum(len(deal(cuts[k + 1] - cuts[k], FLEET_TENANTS)[g]) for k in range(3))
        check(int(got[-1]["rows_through"]) == sent,
              f"fleet (c): tenant {g}'s verdicts cover {got[-1]['rows_through']} of {sent} rows")
        dets.append(sum(int(e["detections"]) for e in ref))
    check(sum(dets) > 0, "fleet (c): no detections to compare")
    rates = ", ".join(f"{r['achieved_rows_per_sec']:,.0f} sent / {r['served_rows_per_s']:,.0f} "
                      f"served (without the router {a:,.0f} / {v:,.0f})"
                      for r, (a, v) in zip(reports, out["rates"]))
    print(f"fleet (c) on the card ({card()}): {FLEET_TENANTS} tenants over 2 serve processes "
          f"{assign} (up in {up_s:.1f} s) behind the router, loadgen --router over v2 in 3 cuts "
          f"of {len(y)} rows: each tenant's verdict entries equal the unmoved "
          f"{FLEET_TENANTS}-slot plane's, whose slots are their solo daemons' (phase 19 (d)) "
          f"(detections {dets}); tenant {g_mig} migrated A -> B after cut 1, paused "
          f"{pause_s:.3f} s; A killed after cut 2, tenant {g_fo} failed over from its checkpoint "
          f"in {failover_s:.3f} s, lost rows 0 (journal); the router's rows/s by cut: {rates}")


def glob_verdicts(d):
    import glob

    return sorted(glob.glob(os.path.join(d, "*.verdicts.jsonl")))


def main(device: str = "cuda") -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    from distributed_drift_detection_tpu_torch import api, config, kernels
    from distributed_drift_detection_tpu_torch.kernels import _build
    from distributed_drift_detection_tpu_torch.models import classifiers
    from distributed_drift_detection_tpu_torch.ops import ddm, detectors

    dev = torch.device(device)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    spent = {}  # seconds by phase, from the last mark
    mark = [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        spent[phase] = round(now - mark[0], 1)
        mark[0] = now

    # 1. the card
    print(card())

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f" (wall {time.perf_counter() - t0:.1f} s, nvcc -gencode "
          "arch=compute_90a,code=sm_90a)")
    from distributed_drift_detection_tpu_torch.io import native

    t0 = time.perf_counter()
    print(f"native CSV parser: {native.build()} ({time.perf_counter() - t0:.1f} s)")
    done("1-2")

    # 3. each kernel against its plain version at the main path's shapes
    cfg = config.RunConfig(**SMOKE)
    prep = api.prepare(cfg, device=dev)
    w, r, p, b = (prep.config.window, prep.config.window_rotations,
                  prep.config.partitions, prep.config.per_batch)
    print(f"main path: {prep.stream.num_rows} rows, W={w} R={r}, packed idx "
          f"{tuple(prep.batches.idx.shape)} {prep.batches.idx.dtype}, perm "
          f"{prep.batches.perm.dtype}, row table {prep.stream.base_X.shape}")
    check((w, r) == (128, 4), f"auto W x R resolved to {w} x {r}, not 128 x 4")
    rows = [check_k1(torch, ddm, kernels, config, p, w, b, dev),
            check_k2(torch, classifiers, kernels, prep.stream, p, w, b, dev),
            check_k7(torch, classifiers, kernels, prep, p, b, dev)]
    done("3")

    # 4. the main path, counted
    t0 = time.perf_counter()
    ref = api.run(cfg, device="cpu")
    print(f"port on the CPU: {ref.metrics.num_detections} detections in "
          f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    res = api.run(cfg, device=dev)
    launches = read_launches()
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
    for name in ("ddm_window", "centroid_predict_err", "centroid_fit"):
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    for row in rows:
        row["launches"] = launches[row["name"]]

    times = [api.run(cfg, device=dev) for _ in range(3)]
    final = statistics.median(t.total_time for t in times)
    phases = {k: statistics.median(t.timings[k] for t in times)
              for k in ("upload", "detect", "collect")}
    print(f"Final Time (median of 3 warm runs): {final:.4f} s, "
          f"{prep.stream.num_rows / final:,.0f} rows/s; phases "
          + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items()))
    done("4")

    # 5. the kernels inside the run
    per, summary = in_run_profile(torch, api, prep, dev)
    print("in-run (one traced detect phase): "
          + ", ".join(f"{k} {c} launches x {us:.2f} us" for k, (c, us) in per.items())
          + f"; {summary['kernels']} kernels busy {summary['busy_s']:.4f} s of "
          f"{summary['detect_s']:.4f} s, idle share {summary['idle_share']:.3f}")
    for row in rows:
        row["in_run_launches"], row["in_run_us"] = per[row["name"]]
    done("5")

    # 6. the zoo kernels against their plain versions
    for _, name in ZOO_PATHS:
        rows.append(check_k5(torch, kernels, config, name, p, w, b, dev))
    done("6")

    # 7. the zoo kernels' paths at SMOKE width, counted
    final_times = {"ddm": final}
    t_phase = time.perf_counter()
    for det, kname in ZOO_PATHS:
        zcfg = config.replace(cfg, detector=det)
        zres, zl = run_equal(api, np, zcfg, dev, det)
        want_n, want_delay = ZOO_EXPECTED[det]
        zm = zres.metrics
        print(f"{det} on the card: {zm.num_detections} detections, mean delay "
              f"{zm.mean_delay_rows:.4f} rows, flags equal to the CPU run, launches {zl}")
        check(zm.num_detections == want_n, f"{det}: {zm.num_detections} detections, expected {want_n}")
        check(abs(zm.mean_delay_rows - want_delay) < 0.01,
              f"{det}: mean delay {zm.mean_delay_rows}, expected {want_delay}")
        check(zl[kname] > 0 and zl["centroid_predict_err"] > 0 and zl["centroid_fit"] > 0,
              f"{det}: kernel {kname}, K2 or K7 was not launched on its path")
        if kname in RING_KERNELS:
            ws = getattr(zcfg, det).window_size
            zctas = detectors.ring_ctas(p, w * b, ws, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            check(zctas > 0, f"{det}: its kernel takes the one-CTA path at SMOKE")
            print(f"{det}: its {zl[kname]} launches on the cluster path, {zctas} CTAs a row "
                  f"(window_size {ws})")
        zrow = next(r for r in rows if r["name"] == kname)
        zrow["launches"] = zl[kname]
        zprep = api.prepare(zcfg, device=dev)
        ztimes = [api.run(zcfg, device=dev) for _ in range(3)]
        final_times[det] = statistics.median(t.total_time for t in ztimes)
        zper, zsum = in_run_profile(torch, api, zprep, dev,
                                    (kname, "centroid_predict_err", "centroid_fit"))
        zrow["in_run_launches"], zrow["in_run_us"] = zper[kname]
        print(f"{det}: Final Time (median of 3 warm runs) {final_times[det]:.4f} s; "
              f"in-run {kname} {zper[kname][0]} launches x {zper[kname][1]:.2f} us; "
              f"{zsum['kernels']} kernels busy {zsum['busy_s']:.4f} s of "
              f"{zsum['detect_s']:.4f} s, idle share {zsum['idle_share']:.3f}")
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s")
    done("7")

    # 8. gnb, linear and window=1 at a smaller depth
    for what, kw, used in SHALLOW:
        scfg = config.replace(cfg, mult_data=SHALLOW_MULT, **kw)
        sres, sl = run_equal(api, np, scfg, dev, what)
        for k in used:
            check(sl[k] > 0, f"{what}: kernel {k} was not launched")
        print(f"{what} (mult_data {SHALLOW_MULT}) on the card: "
              f"{sres.metrics.num_detections} detections, flags equal to the "
              f"CPU run, launches {sl}")
    done("8")

    # 9. the mlp: K8, K9 and K10 against their plain versions, then its path
    # at SMOKE's full width and depth, counted
    from distributed_drift_detection_tpu_torch.models import mlp
    from distributed_drift_detection_tpu_torch.utils import threefry

    mcfg = config.replace(cfg, model="mlp")
    mprep = api.prepare(mcfg, device=dev)
    check(tuple(mprep.config.mlp_hidden) == (128, 64) and mprep.config.fit_steps == 32
          and (mprep.config.window, mprep.config.window_rotations) == (128, 4),
          f"the mlp path resolved to {mprep.config}")
    rows.append(check_k8(torch, kernels, mlp, threefry, mprep, dev))
    k9_row, fitted = check_k9(torch, kernels, mlp, mprep, dev)
    rows.append(k9_row)
    rows.append(check_k10(torch, kernels, mlp, mprep, fitted, dev))
    # the CPU reference at a cut depth (SHALLOW_MULT), against the card's run
    # of that depth: its flags compared, printed
    scut = config.replace(mcfg, mult_data=SHALLOW_MULT)
    t0 = time.perf_counter()
    mref = api.run(scut, device="cpu")
    cpu_s = time.perf_counter() - t0
    mcut = api.run(scut, device=dev)
    reset_launches()
    mres = api.run(mcfg, device=dev)
    ml = read_launches()
    mm, want_n, want_delay = mres.metrics, *MLP_EXPECTED
    same = all(np.array_equal(getattr(mcut.flags, f), getattr(mref.flags, f))
               for f in mcut.flags._fields)
    print(f"mlp on the card: {mm.num_detections} detections, mean delay "
          f"{mm.mean_delay_rows:.4f} rows (the JAX package: {want_n}, {want_delay:.4f}); "
          f"launches {ml}; at mult_data {SHALLOW_MULT} {mcut.metrics.num_detections} "
          f"detections, flags {'equal' if same else 'NOT equal'} bit for bit to the port's "
          f"CPU run ({mref.metrics.num_detections} detections, "
          f"{mref.metrics.mean_delay_rows:.4f} rows, {cpu_s:.1f} s)")
    check(mm.num_detections == want_n, f"mlp: {mm.num_detections} detections, expected {want_n}")
    check(abs(mm.mean_delay_rows - want_delay) <= cfg.per_batch,
          f"mlp: mean delay {mm.mean_delay_rows}, more than a batch from {want_delay}")
    check(bool(np.isfinite(mres.drift_vote).all()), "mlp: non-finite drift vote")
    for k in ("random_normal", "mlp_fit", "mlp_predict_err", "ddm_window"):
        check(ml[k] > 0, f"mlp: kernel {k} was not launched on its path")
    check(ml["random_normal"] == 1, f"mlp: the init took {ml['random_normal']} K8 launches, not 1")
    mtimes = [api.run(mcfg, device=dev) for _ in range(3)]
    final_times["mlp"] = statistics.median(t.total_time for t in mtimes)
    names = ("random_normal", "mlp_fit", "mlp_predict_err")
    mper, msum = in_run_profile(torch, api, mprep, dev, names + ("ddm_window",))
    for row in rows[-3:]:
        row["launches"] = ml[row["name"]]
        row["in_run_launches"], row["in_run_us"] = mper[row["name"]]
    print(f"mlp: Final Time (median of 3 warm runs) {final_times['mlp']:.4f} s; in-run "
          + ", ".join(f"{k} {mper[k][0]} launches x {mper[k][1]:.2f} us" for k in names)
          + f"; {msum['kernels']} kernels busy {msum['busy_s']:.4f} s of "
          f"{msum['detect_s']:.4f} s, idle share {msum['idle_share']:.3f}")
    done("9")

    # 10. the nets of ROADMAP C5 at SMOKE, end to end, counted: detections
    # equal to the JAX package's, mean delay within a batch of SMOKE's; the
    # CPU reference at a cut depth against the card's run of that depth
    # (K9's products follow C4's tolerance)
    for hidden in C5_NETS:
        ccfg = config.replace(mcfg, mlp_hidden=hidden)
        scfg = config.replace(ccfg, mult_data=SHALLOW_MULT)
        t0 = time.perf_counter()
        cref = api.run(scfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        sres = api.run(scfg, device=dev)
        reset_launches()
        cres = api.run(ccfg, device=dev)
        cl = read_launches()
        cm = cres.metrics
        cplan = mlp.k10_launch_plan(dev, mlp_dims(mprep.stream, ccfg), p, w * b)
        ctimes = [api.run(ccfg, device=dev) for _ in range(3)]
        final_times[f"mlp{hidden}"] = statistics.median(t.total_time for t in ctimes)
        cper, csum = in_run_profile(torch, api, api.prepare(ccfg, device=dev), dev,
                                    ("mlp_fit", "mlp_predict_err"))
        print(f"mlp {hidden} on the card: {cm.num_detections} detections, mean delay "
              f"{cm.mean_delay_rows:.4f} rows; at mult_data {SHALLOW_MULT} "
              f"{sres.metrics.num_detections} detections, {sres.metrics.mean_delay_rows:.4f} "
              f"rows (the port's CPU run: {cref.metrics.num_detections}, "
              f"{cref.metrics.mean_delay_rows:.4f} rows, {cpu_s:.1f} s); Final Time (median of 3 warm runs) "
              f"{final_times[f'mlp{hidden}']:.4f} s; K10 plan: {k10_plan_text(cplan)}; "
              f"launches {cl}; in-run "
              + ", ".join(f"{k} {c} launches x {us:.2f} us" for k, (c, us) in cper.items())
              + f"; {csum['kernels']} kernels busy {csum['busy_s']:.4f} s of "
              f"{csum['detect_s']:.4f} s, idle share {csum['idle_share']:.3f}")
        check(cm.num_detections == EXPECTED_DETECTIONS,
              f"mlp {hidden}: {cm.num_detections} detections, expected {EXPECTED_DETECTIONS}")
        check(abs(cm.mean_delay_rows - MLP_EXPECTED[1]) <= cfg.per_batch,
              f"mlp {hidden}: mean delay {cm.mean_delay_rows}, more than a batch from "
              f"SMOKE's {MLP_EXPECTED[1]}")
        check(sres.metrics.num_detections == cref.metrics.num_detections
              and abs(sres.metrics.mean_delay_rows - cref.metrics.mean_delay_rows)
              <= cfg.per_batch,
              f"mlp {hidden} at mult_data {SHALLOW_MULT}: {sres.metrics.num_detections} "
              f"detections, mean delay {sres.metrics.mean_delay_rows}, against the CPU run's "
              f"{cref.metrics.num_detections}, {cref.metrics.mean_delay_rows}")
        check(bool(np.isfinite(cres.drift_vote).all()), f"mlp {hidden}: non-finite drift vote")
        for k in ("random_normal", "mlp_fit", "mlp_predict_err"):
            check(cl[k] > 0, f"mlp {hidden}: kernel {k} was not launched on its path")
    done("10")

    # 11.-14. CSV ingest, wide rows, the forest, the deep mlp
    later, wide_ms = later_phases(torch, api, config, kernels, cfg, res, mcfg, mprep,
                                  final_times, dev)
    for row in rows:
        kid = {"centroid_fit": "K7", "centroid_predict_err": "K2"}.get(row["name"])
        if kid:
            row["wide_ms"] = {k: v for k, v in wide_ms.items() if k.startswith(kid)}
    rows += later
    done("11-14")

    # 15. the paper's experiment loop: CLI, grid, rf, parity, doctor
    cpu_rows = experiment_phase(torch, api, config, dev)
    done("15")

    # 16. the sweep as a fleet: telemetry, the scheduler, crash then heal
    fleet_phase(torch, api, config, dev, res, final, cpu_rows)
    done("16")

    # 17. the device-generated soak and the capture surfaces
    k6_row, fit_ms, _ = soak_phase(torch, api, config, kernels, classifiers, res, dev)
    for row in rows:
        kid = {"centroid_fit": "K7", "centroid_predict_err": "K2"}.get(row["name"])
        if kid:
            row["soak_ms"] = {k: v for k, v in fit_ms.items() if k.startswith(kid)}
    rows.append(k6_row)
    done("17")

    # 18. streaming ingest, the in-loop shuffle (K13) and the tenant plane
    rows.append(chunked_phase(torch, api, config, kernels, cfg, res, dev))
    done("18")

    # 19. the serving daemon on the card
    p19 = serve_phase(torch, api, config, cfg, res, rows, launches, dev)
    done("19")

    # 20. drift adaptation and the tenant router
    adapt_ms = adapt_phase(torch, api, config, kernels, classifiers, cfg, p19, dev)
    for row in rows:
        kid = {"centroid_fit": "K7", "centroid_predict_err": "K2"}.get(row["name"])
        if kid:
            row["adapt_window_ms"] = adapt_ms[kid]
    done("20")
    print(f"seconds by phase: {spent} ({sum(spent.values()):.1f} s in all)")

    print("Final Time at SMOKE by path: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in final_times.items()))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
