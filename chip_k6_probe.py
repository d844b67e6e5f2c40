#!/usr/bin/env python3
"""Variants of kernels K6 (``csrc/soak_gen.cu``) and K8
(``csrc/random_normal.cu``) timed side by side on one card.

Run from the repository root: ``python3 chip_k6_probe.py``. Each variant is
the kernel's source with its block size, its ``__launch_bounds__`` minimum
of resident CTAs, K8's normals a thread, the unrolling of K6's feature
groups or ``csrc/threefry.cuh``'s log1p (both paths computed, one selected:
the same operations without a data-dependent branch) changed by a text
substitution, nothing else, built by nvcc (all at once, with ``-Xptxas
-v`` to print registers and spills) and launched through the port's own
wrapper: K6 at ``chip_smoke.py``'s soak shape — [128, 2000] for each
generator — and K8 as the MLP(128, 64) init of 16 partitions. Every
variant's output must equal the plain version's bit for bit. It times each
variant twice, in the order V0 … Vn, Vn … V0, as ``chip_smoke.graph_ms``
does (a CUDA graph of 50 launches, median of 5 replays), and prints the
card's name and power limit, one line a variant and a last JSON line with
the times (µs). Exits 2 without a card.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

_LAUNCH = "__launch_bounds__(kThreads) soak_tile_kernel"
# XLA's log1p with both of its paths computed and one selected (the same
# operations, no data-dependent branch)
_LOG1P_SELECT = [
    ("threefry.cuh", "  if (fabsf(x) < 0.41421356237309504880f) {\n",
     "  const bool near = fabsf(x) < 0.41421356237309504880f;\n  {\n"),
    ("threefry.cuh", "    return __fadd_rn(x, __fmaf_rn(x2, -0.5f, cubic));\n  }\n"
     "  return xla_logf(__fadd_rn(x, 1.0f));\n",
     "    const float far = xla_logf(__fadd_rn(x, 1.0f));\n"
     "    return near ? __fadd_rn(x, __fmaf_rn(x2, -0.5f, cubic)) : far;\n  }\n"),
]
# (name, substitutions (file, old, new), "cu" the kernel's source) on K6
K6_VARIANTS = [
    ("256 threads", []),
    ("256 threads, 8 CTAs an SM", [("cu", _LAUNCH, "__launch_bounds__(kThreads, 8) soak_tile_kernel")]),
    ("128 threads", [("cu", "constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]),
    ("log1p by select", _LOG1P_SELECT),
    ("log1p by select, 8 CTAs an SM",
     _LOG1P_SELECT + [("cu", _LAUNCH, "__launch_bounds__(kThreads, 8) soak_tile_kernel")]),
    ("a group's features one by one",
     [("cu", "  float v[4];\n#pragma unroll\n", "  float v[4];\n#pragma unroll 1\n")]),
]
# (name, substitutions) on K8
K8_VARIANTS = [
    ("1 normal a thread", []),
    ("2 normals a thread", [("cu", "constexpr int kPer = 1;", "constexpr int kPer = 2;")]),
    ("4 normals a thread", [("cu", "constexpr int kPer = 1;", "constexpr int kPer = 4;")]),
    ("1 normal a thread, log1p by select", _LOG1P_SELECT),
]


def build(name: str, subs, out_dir: str, tag: str) -> tuple[str, str]:
    """The variant's library and ptxas's report."""
    from distributed_drift_detection_tpu_torch.kernels import _build

    files = {"cu": _build.source(name).read_text(),
             "threefry.cuh": (_build.CSRC / "threefry.cuh").read_text()}
    for where, old, new in subs:
        if old not in files[where]:
            raise SystemExit(f"chip_k6_probe: {old!r} not in {where} ({name})")
        files[where] = files[where].replace(old, new)
    vdir = os.path.join(out_dir, f"{name}-{tag}")
    os.makedirs(vdir)
    for header in _build.CSRC.glob("*.cuh"):  # the variant's own headers
        text = files["threefry.cuh"] if header.name == "threefry.cuh" else header.read_text()
        with open(os.path.join(vdir, header.name), "w") as fh:
            fh.write(text)
    path = os.path.join(vdir, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write(files["cu"])
    lib = path[:-3] + ".so"
    cmd = [_build.nvcc(), *_build.COMMON_FLAGS, *_build.KERNELS[name], "-Xptxas", "-v",
           "-o", lib, path]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(f"chip_k6_probe: nvcc failed on {name} {tag}:\n{proc.stderr}")
    regs = re.findall(r"entry function '(\w+)'.*?Used (\d+) registers", proc.stderr, re.S)
    spills = re.findall(r"(\d+) bytes spill stores", proc.stderr)
    short = re.compile(r"^.*?(soak_tile_kernel\w{0,6}|init_normals_kernel)")
    report = "; ".join(f"{short.sub(lambda m: m.group(1), f)[:22]} {r} regs"
                       for f, r in regs if "floor" not in f)
    return lib, f"{report}; spill stores {max(map(int, spills or ['0']))} B"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k6_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from distributed_drift_detection_tpu_torch import kernels
    from distributed_drift_detection_tpu_torch.engine import soak
    from distributed_drift_detection_tpu_torch.models import mlp
    from distributed_drift_detection_tpu_torch.utils import threefry

    print(cs.card())
    tmp = tempfile.mkdtemp(prefix="k6probe-")
    jobs = [("soak_batch", f"v{i}", v) for i, v in enumerate(K6_VARIANTS)]
    jobs += [("random_normal", f"v{i}", v) for i, v in enumerate(K8_VARIANTS)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(j[0], j[2][1], tmp, j[1]), jobs))
    libs = {}
    for (name, tag, (label, _)), (lib, report) in zip(jobs, built):
        fn = getattr(ctypes.CDLL(lib), kernels._SIGNATURES[name][0])
        fn.argtypes, fn.restype = kernels._SIGNATURES[name][1], ctypes.c_int
        libs[(name, tag)] = fn
        print(f"{name} {tag} ({label}): {report}")

    dev = torch.device("cuda")
    real = kernels.launcher
    feeds = {}
    for gen, f, _ in cs.SOAK_GENS:
        feed = cs.k6_feed(torch, soak, gen, f, cs.SOAK_P, cs.SOAK_B, cs.SOAK_DE, 1, 7, 4099,
                          "global", dev)
        want = soak.soak_batch_reference(*feed[:6], **feed[6])
        feeds[gen] = (feed, want)
    dims = (21, 128, 64, 40)
    keys = torch.from_numpy(threefry.split(threefry.key(5), 16).view("int32").copy()).to(dev)
    counts = [a * b for a, b in zip(dims[:-1], dims[1:])]
    zeros = 16 * sum(dims[1:])
    init_want = threefry.init_normals_reference(keys.cpu(), counts, mlp.init_scales(dims), zeros)

    times = {}
    order = list(libs)
    for key in order + order[::-1]:
        name, tag = key
        kernels.launcher = lambda n, fn=libs[key]: fn if n == name else real(n)
        try:
            if name == "soak_batch":
                for gen, (feed, want) in feeds.items():
                    out = soak.soak_batch(*feed[:6], **feed[6])
                    torch.cuda.synchronize()
                    cs.check(torch.equal(out.table.view(torch.int32), want.table.view(torch.int32))
                             and torch.equal(out.labels, want.labels)
                             and torch.equal(out.rows, want.rows),
                             f"K6 {tag} differs from its plain version ({gen})")
                    us = cs.graph_ms(lambda: soak.soak_batch(*feed[:6], out=out, **feed[6])) * 1e3
                    times.setdefault(f"K6 {tag} {gen}", []).append(us)
            else:
                got = threefry.init_normals(keys, counts, mlp.init_scales(dims), zeros)
                cs.check(torch.equal(got.cpu().view(torch.int32), init_want.view(torch.int32)),
                         f"K8 {tag} differs from its plain version")
                us = cs.graph_ms(lambda: threefry.init_normals(keys, counts, mlp.init_scales(dims),
                                                               zeros)) * 1e3
                times.setdefault(f"K8 {tag}", []).append(us)
        finally:
            kernels.launcher = real
    for k, v in times.items():
        print(f"{k}: {' / '.join(f'{x:.3f}' for x in v)} us")
    print(json.dumps({k: sorted(v) for k, v in times.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
