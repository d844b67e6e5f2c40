#!/usr/bin/env python3
"""Where K11's and K12's time goes, on one card: variants and phase clocks.

Run from the repository root: ``python3 chip_forest_probe.py``. It needs
one CUDA card and nvcc (exits 2 without a card). Each variant is the
committed source (``csrc/forest_fit.cu``, ``csrc/forest_predict_err.cu``)
with a few lines replaced, as listed in ``K12_VARIANTS`` and
``K11_VARIANTS`` (a replacement that no longer matches the source stops the
script); the variants are built with nvcc into ``kernels/_build/probe/``
with the kernels' own flags and called through the same C interface, at the
forest path's shapes of ``chip_smoke.py`` (``SMOKE``, 32 trees of depth 3):

* K12 on K11's parameters fitted on random rows (``chip_smoke.k7_inputs``,
  so the leaves hold many classes) over ``chip_smoke.k10_main_inputs`` at
  [16, 12,800]: each variant's device time (``chip_smoke.graph_ms``, graphs
  of 10, two readings) and whether its predictions and errors equal the
  plain version's. ``uniform columns`` (every level reads its tree's root
  column, the same address for every lane) and ``no tally`` (the votes
  summed, not counted) compute something else: they time what the walk's
  divergent column loads and the tally cost.
* K11 on the main path's first training batch with its fit keys: a build
  that reads ``clock64`` and ``%globaltimer`` on thread 0 of each CTA at the
  phase boundaries — draws, z, selection, routing, leaf classes — and
  prints the median and largest cycles of each phase over the CTAs, the
  spread of the CTAs' start times and the kernel's span; beside it the
  device time of each K11 variant and whether its outputs equal K11's.

It prints the card's name and power limit, then one line per reading.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (name, [(old, new), ...], computes the kernel's function)
K12_VARIANTS = [
    ("as committed: two trees, 8 CTAs an SM", [], True),
    ("four trees, 4 CTAs an SM (the first draft)",
     [("constexpr int kGroup = 2;", "constexpr int kGroup = 4;"),
      ("__launch_bounds__(kThreads, NV <= 8 ? 8 : 4)", "__launch_bounds__(kThreads, 4)")], True),
    ("four trees, 8 CTAs an SM",
     [("constexpr int kGroup = 2;", "constexpr int kGroup = 4;")], True),
    ("one tree, 8 CTAs an SM", [("constexpr int kGroup = 2;", "constexpr int kGroup = 1;")], True),
    ("two trees, 12 CTAs an SM",
     [("__launch_bounds__(kThreads, NV <= 8 ? 8 : 4)", "__launch_bounds__(kThreads, NV <= 8 ? 12 : 4)")],
     True),
    ("level 1 from both children's columns, the same address for every lane",
     [("        const float4 p = col[g][v];\n",
       "        float4 p;\n"
       "        if (d == 1) {  // nodes 1 and 2: one address each for the warp\n"
       "          const float4* c1 = col[g] - (node[g] - 1) * kS4;\n"
       "          const float4 p1 = c1[v], p2 = c1[kS4 + v];\n"
       "          p = node[g] == 2 ? p2 : p1;\n"
       "        } else {\n"
       "          p = col[g][v];\n"
       "        }\n")], True),
    ("uniform columns (timing only)",
     [("      col[g] = ps4 + ((t0 + g) * n + node[g]) * kS4;",
       "      col[g] = ps4 + ((t0 + g) * n) * kS4;")], False),
    ("no tally (timing only)",
     [("  __device__ __forceinline__ void add(int v, int t) {\n",
       "  __device__ __forceinline__ void add(int v, int t) {\n    best += v;\n    return;\n"),
      ("  __device__ __forceinline__ void clear(int trees) {\n",
       "  __device__ __forceinline__ void clear(int trees) {\n    return;\n")], False),
]

K11_VARIANTS = [
    ("as committed", []),
    ("4 CTAs an SM (64 registers)",
     [("__global__ void __launch_bounds__(kThreads) forest_fit_kernel(",
       "__global__ void __launch_bounds__(kThreads, 4) forest_fit_kernel(")]),
    ("a row onto 4 columns at once",
     [("constexpr int kCols = 8;", "constexpr int kCols = 4;")]),
]

# K11's phase clocks: (anchor, what follows it)
CLOCK_DEFS = (
    "__device__ long long g_clk[4096][8];\n__device__ long long g_gt[4096][8];\n"
    "#define CLK(i) do { if (threadIdx.x == 0 && blockIdx.x < 4096) { long long t_; "
    "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
    "g_clk[blockIdx.x][i] = clock64(); g_gt[blockIdx.x][i] = t_; } } while (0)\n")
K11_CLOCKS = [
    ('#include "threefry.cuh"\n', '#include "threefry.cuh"\n' + CLOCK_DEFS),
    ("  // the fit key's two halves, split once by warp 0",
     "  CLK(0);\n  // the fit key's two halves, split once by warp 0"),
    ("  __syncthreads();\n  if (xs != nullptr) X = xs;",
     "  __syncthreads();\n  CLK(1);\n  if (xs != nullptr) X = xs;"),
    ("        if (q < mc) zb[static_cast<size_t>(m1 - c0 + q) * b + r] = acc[q];\n    }\n"
     "    __syncthreads();",
     "        if (q < mc) zb[static_cast<size_t>(m1 - c0 + q) * b + r] = acc[q];\n    }\n"
     "    __syncthreads();\n    CLK(2);"),
    ("        if (pl.th_staged) ths[m] = th;\n      }\n    }\n    __syncthreads();",
     "        if (pl.th_staged) ths[m] = th;\n      }\n    }\n    __syncthreads();\n    CLK(3);"),
    ("      ids[r] = leaf;\n    }\n  }\n  __syncthreads();",
     "      ids[r] = leaf;\n    }\n  }\n  __syncthreads();\n  CLK(4);"),
    ("      if (lane == 0) lp[l] = best > 0 ? at : major;\n    }\n    return;",
     "      if (lane == 0) lp[l] = best > 0 ? at : major;\n    }\n    __syncthreads();\n"
     "    CLK(5);\n    return;"),
]
CLOCK_EXPORTS = (
    '\nextern "C" int probe_clocks(long long* clk, long long* gt) {\n'
    "  cudaError_t e = cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));\n"
    "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, g_gt, sizeof(g_gt));\n"
    "  return static_cast<int>(e);\n}\n")
PHASES = ("draws", "z", "selection", "routing", "leaf classes")


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"chip_forest_probe: the source no longer has {old!r}")
        src = src.replace(old, new, 1)
    return src


def build_all(jobs):
    """Build ``(name, kernel, source text)`` jobs in parallel; returns
    {name: library path}."""
    from distributed_drift_detection_tpu_torch.kernels import _build

    out_dir = os.path.join(str(_build.BUILD_DIR), "probe")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir)

    def one(i, name, kernel, text):
        src = os.path.join(out_dir, f"v{i}_{kernel}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        lib = os.path.join(out_dir, f"libv{i}_{kernel}.so")
        proc = subprocess.run([_build.nvcc(), *_build.COMMON_FLAGS, *_build.KERNELS[kernel],
                               "-o", lib, src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"chip_forest_probe: nvcc failed on {name}:\n{proc.stderr[-4000:]}")
        return name, lib

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(lambda a: one(*a), [(i, *j) for i, j in enumerate(jobs)]))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_forest_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from distributed_drift_detection_tpu_torch import api, config, kernels
    from distributed_drift_detection_tpu_torch.kernels import _build
    from distributed_drift_detection_tpu_torch.models import forest

    print(cs.card())
    k12_src = (_build.CSRC / "forest_predict_err.cu").read_text()
    k11_src = (_build.CSRC / "forest_fit.cu").read_text()
    jobs = [(name, "forest_predict_err", variant_source(k12_src, edits))
            for name, edits, _ in K12_VARIANTS]
    jobs += [(name, "forest_fit", variant_source(k11_src, edits)) for name, edits in K11_VARIANTS]
    jobs.append(("K11 phase clocks", "forest_fit",
                 variant_source(k11_src, K11_CLOCKS) + CLOCK_EXPORTS))
    libs = build_all(jobs)

    dev = torch.device("cuda")
    prep = api.prepare(config.RunConfig(**cs.SMOKE, model="forest"), device=dev)
    cfg, st = prep.config, prep.stream
    trees, depth, c, f = cfg.forest_trees, cfg.forest_depth, st.num_classes, st.num_features
    p, b, n = cfg.partitions, cfg.per_batch, cfg.window * cfg.per_batch
    _, keys = cs.mlp_keys(torch, prep, dev)
    main_batch = [torch.from_numpy(a).to(dev) for a in cs.k7_main_batch(prep.batches)]
    rand = [torch.from_numpy(a).to(dev) for a in cs.k7_inputs(
        np.random.default_rng(3), st.base_X, st.base_y, p, b, c)]
    params = forest.forest_fit(keys, *rand, trees, depth, c)
    T, Ty, idx = (torch.from_numpy(a).to(dev) for a in cs.k10_main_inputs(st, p, n))
    Tp = forest.pad_row_table(T)
    rerr, rpred = forest.forest_predict_err_reference(params, Tp, Ty, idx)
    print(f"K12 at [{p}, {n}] F={f} T={trees} depth {depth}, C={c}; plan "
          f"{forest.k12_plan(dev, p, n, f, trees, depth, c)._asdict()}")

    def loaded(name, symbol, sig):
        fn = getattr(ctypes.CDLL(libs[name]), symbol)
        fn.argtypes, fn.restype = kernels._SIGNATURES[sig][1], ctypes.c_int
        return fn

    for name, _, exact in K12_VARIANTS:
        fn = loaded(name, "forest_predict_err_launch", "forest_predict_err")
        err = torch.empty((p, n), device=dev)
        pred = torch.empty((p, n), dtype=torch.int32, device=dev)
        args = forest.forest_predict_err_args(params, Tp, Ty, idx, c, err, pred, None)

        def launch(fn=fn, args=args):
            kernels.check("forest_predict_err", fn(*args, kernels.stream_handle(dev)))

        launch()
        torch.cuda.synchronize()
        equal = torch.equal(err, rerr) and torch.equal(pred, rpred)
        ms = [cs.graph_ms(launch, reps=10, rounds=3) for _ in range(2)]
        print(f"K12 {name}: {ms[0] * 1e3:.2f}, {ms[1] * 1e3:.2f} us a launch; equal to the plain "
              f"version: {equal}" + ("" if exact else " (computes something else)"))

    want = forest.forest_fit(keys, *main_batch, trees, depth, c)
    print(f"K11 at [{p}, {b}] F={f} C={c} T={trees} depth {depth} ({p * trees} CTAs); layout "
          f"{forest.k11_plan(b, f, c, trees, depth)._asdict()}")
    for name, _ in K11_VARIANTS + [("K11 phase clocks", None)]:
        fn = loaded(name, "forest_fit_launch", "forest_fit")
        out = forest.ForestParams(*(torch.empty_like(t) for t in want))
        args = forest.forest_fit_args(keys, *main_batch, trees, depth, c, out, None)

        def launch(fn=fn, args=args):
            kernels.check("forest_fit", fn(*args, kernels.stream_handle(dev)))

        launch()
        torch.cuda.synchronize()
        equal = all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(out, want))
        ms = [cs.graph_ms(launch) for _ in range(2)]
        print(f"K11 {name}: {ms[0] * 1e3:.2f}, {ms[1] * 1e3:.2f} us a launch; equal to K11: {equal}")
    lib = ctypes.CDLL(libs["K11 phase clocks"])
    clk, gt = (ctypes.c_longlong * (4096 * 8))(), (ctypes.c_longlong * (4096 * 8))()
    launch()
    torch.cuda.synchronize()
    kernels.check("probe_clocks", lib.probe_clocks(clk, gt))
    cyc = np.array(clk, dtype=np.float64).reshape(4096, 8)[: p * trees, :6]
    ns = np.array(gt, dtype=np.float64).reshape(4096, 8)[: p * trees, :6]
    d = np.diff(cyc, axis=1)
    print("K11 phase cycles, median / largest over the CTAs: " + ", ".join(
        f"{ph} {np.median(d[:, i]):.0f} / {d[:, i].max():.0f}" for i, ph in enumerate(PHASES)))
    print(f"K11 CTAs' start times spread over {ns[:, 0].max() - ns[:, 0].min():.0f} ns; first start "
          f"to last end {ns[:, 5].max() - ns[:, 0].min():.0f} ns; a CTA's median span "
          f"{np.median(ns[:, 5] - ns[:, 0]):.0f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
