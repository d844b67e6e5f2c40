#!/usr/bin/env python3
"""Device time of the port's hand-written kernels in several trees, on one card.

Run from the repository root:
``python3 chip_kernel_ab.py [--only NAME[,NAME...]] TREE [TREE ...]``, where
each TREE is a checkout of another commit or variant of this repository
(for example ``git archive <commit> | tar -x -C TREE``). It runs the TREEs
in order, this tree twice, then the TREEs in reverse order, each in a
process of its own, so all are compared on one card with the drift between
runs visible. Each run builds that tree's kernels and times K1
(``ddm_window``), K2 (``centroid_predict_err``), K7 (``centroid_fit``) and
the zoo kernels K5-ph (``ph_window``), K5-hddm_w (``hddm_w_window``),
K5-adwin (``adwin_window``), K5-eddm (``eddm_window``), K5-hddm
(``hddm_window``), K5-kswin (``kswin_window``) and K5-stepd
(``stepd_window``), K13 (``shuffle_perm``), K9 (``mlp_fit``) and K10
(``mlp_predict_err``) at ``chip_smoke.py``'s main-path shapes on the same
inputs (K7 on the main path's first training batch, and as
``centroid_fit_random_rows`` on a batch of random rows; K9 on the main
path's first training batch with its fit keys, 32 steps of MLP(128, 64);
K10 on ``chip_smoke.k10_main_inputs`` with the parameters K9 fits there) —
a kernel a tree does not have is left out of its run, and ``--only`` keeps
the named kernels alone:

* ``ms``: device time of one launch — 50 calls of the kernel's wrapper
  captured into one CUDA graph (a wrapper enqueues nothing but its kernel,
  so the graph holds 50 kernel launches), replays timed with CUDA events,
  median of 5 rounds (``chip_smoke.graph_ms``);
* ``host_us``: the wrapper's host cost per call (``chip_smoke.host_us``,
  the median of 5 rounds of 200 calls);
* ``floor_ms`` (K5-eddm, K5-hddm, K5-kswin and K5-stepd, where the tree
  has their empty twins): an empty kernel launched as the kernel is, timed
  as ``ms`` is, beside ``ctas``, the CTAs a row of the kernel's launch (0:
  one CTA a row).

K9 is timed as ``chip_smoke.py`` times it: ``ms`` over graphs of 10
launches (3 rounds), ``host_us`` over 3 rounds of 20 calls, and
``floor_ms``, an empty kernel launched with K9's grid, cluster, block and
shared memory; beside them the SHA-256 of the fitted parameters' bytes on
that batch (``digest``) and on chip_smoke's F = 27 batch (``digest_f27``),
which must be equal across trees (K9's redesigns keep every chain). A tree
whose K9 launches a cluster a partition is timed at the size its launcher
picks (``cluster_ctas``); ``chip_smoke.py`` times the other sizes.

K10 is timed through its wrapper as K1 is, over graphs of 10 launches (3
rounds), beside the SHA-256 of its predictions and errors there
(``digest``) and on ``chip_smoke.k10_f27_case`` (``digest_f27``), which
must be equal across trees (K10's redesign keeps every chain).

K11 (``forest_fit``) and K12 (``forest_predict_err``) are timed through
their wrappers on the forest path's shapes (32 trees of depth 3): K11 on
the main path's first training batch with its fit keys (graphs of 50),
K12 on K11's parameters over ``chip_smoke.k10_main_inputs`` at [16,
12,800] (graphs of 10, 3 rounds), each beside the SHA-256 of its outputs
(``digest``: K11's proj, thresh and leaf_class; K12's predictions and
errors), which must be equal across trees (K11 and K12 are bit for bit
their plain versions in every tree).

K6 (``soak_batch``) is timed through its wrapper (its output
preallocated, so the graph holds its kernel alone) at ``chip_smoke.py``'s
soak shape, [128, 2000] prototypes at F = 8, beside the SHA-256 of its
table, labels and row positions (``digest``), which must be equal across
trees (K6 is bit for bit its plain version in every tree).

``mlp_init`` is the MLP(128, 64) init of the main path's 16 partitions
(``models/mlp.py`` ``mlp_init`` on the init keys, as the engine calls it),
whatever kernels a tree launches for it: ``busy_us``, the device time of
its kernels a call and ``kernels``, their number (``torch.profiler`` over
20 calls); ``host_us``, the host's cost a call; ``digest``, the SHA-256 of
the parameters' bytes, which must be equal across trees.

K13 (``shuffle_perm``) is timed through its wrapper at ``chip_smoke.py``'s
``K13_TIMED`` shapes with derived keys and each lane's start: [16, 128,
100] (``shuffle_perm``, the shuffled window engine's launch), [16, 8, 100]
(``shuffle_perm_w8``, the window-8 run's) and [16, 1, 100]
(``shuffle_perm_w1``, the ``window=1`` step's), each with ``floor_ms``
(its empty twin launched as the tree's launch is) and the SHA-256 of its
three output planes (``digest``), which must be equal across trees (K13
is bit for bit its plain version in every tree). Its other paths are
timed the same way at ``K13_PATH_SHAPES`` (``shuffle_perm_PxWxB``): the
warp path's widest batch [16, 128, 1024], the CTA path's [3, 128, 1025]
(one round), [3, 128, 2000] (two rounds), [3, 128, 4000], [2, 32, 8192]
(16 composites a thread) and [2, 9, 16384] (32), and the
global path's [2, 128, 20000]; each row names the tree's path
(``k13_layout``) and its bound (``chip_smoke.bound``). ``local_ops``
counts the local-memory loads and stores (``LDL``, ``STL``: register
spills) in the SASS of the tree's K13 library.

It prints the card's name and power limit, one JSON line per run, and a
last JSON line with each tree's medians. Exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def one(root: str, only: set | None = None) -> dict:
    """Time the kernels of the tree at ``root`` — those in ``only``, if
    given (this process imports its package, so it runs in a process of
    its own)."""
    import numpy as np
    import torch

    import chip_smoke as cs  # this tree's helpers; they import no package

    sys.path[:] = [root] + [x for x in sys.path if os.path.abspath(x or ".") != HERE]
    from distributed_drift_detection_tpu_torch import api, config
    from distributed_drift_detection_tpu_torch.kernels import _build
    from distributed_drift_detection_tpu_torch.models import classifiers
    from distributed_drift_detection_tpu_torch.ops import ddm

    assert os.path.abspath(ddm.__file__).startswith(os.path.abspath(root) + os.sep)
    dev = torch.device("cuda")
    if only is None:
        _build.build_all()
    else:
        names = only & set(_build.KERNELS)
        if "mlp_init" in only:
            names.add("random_normal")  # K8, the init's kernel in every tree
        for name in names:
            _build.build(name)
    prep = api.prepare(config.RunConfig(**cs.SMOKE), device=dev)
    p, w, b = prep.config.partitions, prep.config.window, prep.config.per_batch

    rng = np.random.default_rng(1)
    prm = config.DDMParams()
    e0, v0 = (torch.from_numpy(a).to(dev) for a in cs.ddm_inputs(rng, p, 1, 300))
    e1, v1 = (torch.from_numpy(a).to(dev) for a in cs.ddm_inputs(rng, p, w, b))
    state, _ = ddm.ddm_window_reference(ddm.ddm_init((p,), dev), e0, v0, prm)

    def k1():
        return ddm.ddm_window(state, e1, v1, prm)

    st = prep.stream
    cent, bias, T, Ty, idx = (
        torch.from_numpy(a).to(dev)
        for a in cs.k2_inputs(np.random.default_rng(2), st.base_X, st.base_y,
                              p, w * b, st.num_classes)
    )
    # the table as the tree's window engine hands it to K2
    pad = getattr(classifiers, "pad_row_table", None)
    Tk = pad(T) if pad else T

    def k2():
        return classifiers.centroid_predict_err(cent, bias, Tk, Ty, idx)

    calls = {"ddm_window": k1, "centroid_predict_err": k2}
    if hasattr(classifiers, "centroid_fit"):
        # the main path's first training batch (one class a partition)
        fX, fy, fw = (torch.from_numpy(a).to(dev) for a in cs.k7_main_batch(prep.batches))

        # and a batch of random rows (about 2.5 rows a class)
        rX, ry, rw = (torch.from_numpy(a).to(dev) for a in cs.k7_inputs(
            np.random.default_rng(3), st.base_X, st.base_y, p, b, st.num_classes))

        def k7(X=fX, y=fy, w=fw):
            return classifiers.centroid_fit(X, y, w, st.num_classes)

        calls["centroid_fit"] = k7
        calls["centroid_fit_random_rows"] = lambda: k7(rX, ry, rw)
    try:
        from distributed_drift_detection_tpu_torch.ops import adwin, detectors
    except ImportError:
        adwin = None
    if adwin is not None:
        ze, zv = (torch.from_numpy(a).to(dev)
                  for a in cs.ddm_inputs(np.random.default_rng(1), p, w, b))
        kswin_prm, stepd_prm = config.KSWINParams(), config.STEPDParams()
        zoo = {
            "ph_window": (lambda: detectors.ph_init((p,), dev), config.PHParams(threshold=32.0)),
            "hddm_w_window": (lambda: detectors.hddm_w_init((p,), dev), config.HDDMWParams()),
            "adwin_window": (lambda: adwin.adwin_init(config.ADWINParams(), (p,), dev),
                             config.ADWINParams()),
            "eddm_window": (lambda: detectors.eddm_init((p,), dev), config.EDDMParams()),
            "hddm_window": (lambda: detectors.hddm_init((p,), dev), config.HDDMParams()),
            "kswin_window": (lambda: detectors.kswin_init(kswin_prm, (p,), dev), kswin_prm),
            "stepd_window": (lambda: detectors.stepd_init(stepd_prm, (p,), dev), stepd_prm),
        }
        for name, (init, prm) in zoo.items():
            fn = getattr(adwin if name == "adwin_window" else detectors, name, None)
            if fn is None:
                continue  # a tree without this kernel

            def call(fn=fn, zstate=init(), prm=prm):
                return fn(zstate, ze, zv, prm)

            calls[name] = call
    out = {"tree": root}
    for name, call in calls.items():
        if only is None or name in only:
            out[name] = {"ms": cs.graph_ms(call), "host_us": cs.host_us(call)}
    out.update(zoo_floors(torch, cs, dev, p, w, b, out))
    if only is None or "mlp_fit" in only:
        out.update(k9_runs(torch, cs, prep, dev))
    if only is None or "mlp_predict_err" in only:
        out.update(k10_runs(torch, cs, prep, dev))
    if only is None or only & {"forest_fit", "forest_predict_err"}:
        out.update(forest_runs(torch, cs, dev, only))
    if (only is None or "soak_batch" in only) and "soak_batch" in _build.KERNELS:
        out.update(k6_runs(torch, cs, dev))
    if only is None or "mlp_init" in only:
        out.update(init_runs(torch, cs, prep, dev))
    if (only is None or "shuffle_perm" in only) and "shuffle_perm" in _build.KERNELS:
        out.update(k13_runs(torch, cs, dev))
    return out


# K13's other paths: the warp path's widest batch, the CTA path at one
# round, two rounds, its widest batches of 16 composites a thread and its
# widest batch (32 a thread), the global path.
K13_PATH_SHAPES = ((16, 128, 1024), (3, 128, 1025), (3, 128, 2000), (3, 128, 4000),
                   (2, 32, 8192), (2, 9, 16384), (2, 128, 20000))


def k13_local_ops(library: str) -> "int | None":
    """Local-memory loads and stores (``LDL``, ``STL``) in the SASS of
    ``library`` (``cuobjdump -sass``); None where cuobjdump is missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          timeout=120).stdout
    return len(re.findall(r"\b(?:LDL|STL)\b", sass))


def k13_runs(torch, cs, dev) -> dict:
    """K13 of the tree through its wrapper at ``chip_smoke.K13_TIMED`` and
    ``K13_PATH_SHAPES`` (derived keys, each lane's start; see the
    docstring)."""
    import numpy as np

    from distributed_drift_detection_tpu_torch import kernels
    from distributed_drift_detection_tpu_torch.kernels import _build
    from distributed_drift_detection_tpu_torch.ops import shuffle

    rows = {}
    floor = kernels.launcher("shuffle_perm_floor")
    for p, w, b in cs.K13_TIMED + K13_PATH_SHAPES:
        nb = cs.CHUNK_BATCHES + w
        planes = cs.k13_planes(torch, p, nb, b, torch.int32, dev, 1)
        keys = cs.k13_keys(torch, (p, 2), dev, 3)
        start = torch.from_numpy(np.random.default_rng(5).integers(0, cs.CHUNK_BATCHES, p)).to(dev)

        def call(keys=keys, planes=planes, w=w, start=start):
            return shuffle.shuffle_planes(keys, *planes, w, start)

        if (p, w, b) in cs.K13_TIMED:
            name = "shuffle_perm" if w == 128 else f"shuffle_perm_w{w}"
        else:
            name = f"shuffle_perm_{p}x{w}x{b}"
        nbytes = p * w * b * (4 + 4 + 1) * 2 + p * (8 + 8)  # as chip_smoke.k13_timed
        rows[name] = {
            "digest": _digest(*call()), "ms": cs.graph_ms(call), "host_us": cs.host_us(call),
            "floor_ms": cs.graph_ms(lambda p=p, w=w, b=b: kernels.check(
                "shuffle_perm_floor", floor(p, w, b, 0, kernels.stream_handle(dev)))),
            "bound_ms": cs.bound(nbytes, 0, cs.k13_int_ops(p, w, b))[0],
            "path": shuffle.k13_layout(b)["path"],
        }
    rows["shuffle_perm"]["local_ops"] = k13_local_ops(str(_build.library_path("shuffle_perm")))
    return rows


def zoo_floors(torch, cs, dev, p, w, b, out) -> dict:
    """``floor_ms`` of K5-eddm, K5-hddm, K5-kswin and K5-stepd where the
    tree has their empty twins: each launched as its kernel is at [p, w·b]
    on the path its launcher takes there (the same grid, cluster, block and
    dynamic shared memory; the ring members at their default window_size,
    on their cluster path in a tree with ``ring_ctas``, else one CTA),
    timed as ``ms`` is, beside the CTAs a row of that path (0: one CTA)."""
    from distributed_drift_detection_tpu_torch import config, kernels
    from distributed_drift_detection_tpu_torch.ops import detectors

    rows = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("eddm_window", "hddm_window", "kswin_window", "stepd_window"):
        floor_name = f"{name}_floor"
        if name not in out or floor_name not in kernels._SIGNATURES:
            continue
        if name in ("kswin_window", "stepd_window"):
            ws = (config.KSWINParams() if name == "kswin_window"
                  else config.STEPDParams()).window_size
            ctas = detectors.ring_ctas(p, w * b, ws, sms) if hasattr(detectors, "ring_ctas") else 0
            # a tree with the cluster path takes its CTAs a row after the window
            last = (ws, ctas) if len(kernels._SIGNATURES[floor_name][1]) == 6 else (ws,)
        else:
            ctas = detectors.cluster_ctas(p, w * b, sms)
            last = (ctas,)
        rows[name] = {"ctas": ctas}
        fn = kernels.launcher(floor_name)
        ms = cs.graph_ms(lambda fn=fn, last=last, floor_name=floor_name: kernels.check(
            floor_name, fn(p, w, b, *last, kernels.stream_handle(dev))))
        rows.setdefault(name, {})["floor_ms"] = ms
    return {k: {**out[k], **v} for k, v in rows.items()}


def _digest(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def k6_runs(torch, cs, dev) -> dict:
    """K6 of the tree at the soak's [128, 2000] prototypes batch, F = 8."""
    from distributed_drift_detection_tpu_torch.engine import soak

    gen, f, _ = cs.SOAK_GENS[0]
    feed = cs.k6_feed(torch, soak, gen, f, cs.SOAK_P, cs.SOAK_B, cs.SOAK_DE, 1, 7, 4099,
                      "global", dev)
    kw = feed[6]
    got = soak.soak_batch(*feed[:6], **kw)
    row = {"digest": _digest(got.table, got.labels, got.rows)}

    def call():
        return soak.soak_batch(*feed[:6], out=got, **kw)

    row["ms"] = cs.graph_ms(call)
    row["host_us"] = cs.host_us(call)
    return {"soak_batch": row}


def init_runs(torch, cs, prep, dev) -> dict:
    """The tree's MLP init on the main path's init keys (see the docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_drift_detection_tpu_torch.models import mlp

    dims = cs.mlp_dims(prep.stream, prep.config)
    keys, _ = cs.mlp_keys(torch, prep, dev)

    def call():
        return mlp.mlp_init(keys, dims)

    params = call()
    row = {"digest": _digest(*(t for layer in params for t in layer))}
    torch.cuda.synchronize()
    calls = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    row["busy_us"] = sum(e.self_device_time_total for e in kern) / calls
    row["kernels"] = sum(e.count for e in kern) / calls
    row["host_us"] = cs.host_us(call)
    return {"mlp_init": row}


def k9_runs(torch, cs, prep, dev) -> dict:
    """K9 of the tree on the path: timed and digested (see the docstring)."""
    import ctypes

    from distributed_drift_detection_tpu_torch import kernels
    from distributed_drift_detection_tpu_torch.models import mlp

    cfg, st = prep.config, prep.stream
    dims = (st.num_features, *cfg.mlp_hidden, st.num_classes)
    steps, lr = cfg.fit_steps, cfg.mlp_learning_rate
    _, keys = cs.mlp_keys(torch, prep, dev)
    batch = [torch.from_numpy(a).to(dev) for a in cs.k7_main_batch(prep.batches)]
    p, b = batch[0].shape[:2]
    f27 = [torch.from_numpy(a).to(dev) for a in cs.k9_f27_batch()]
    f27_dims = (cs.K9_F27[2], *cs.K9_F27[4], cs.K9_F27[3])
    f27_keys = keys[: cs.K9_F27[0]].contiguous()
    # a tree whose K9 launches a cluster a partition takes its size as an
    # argument of the kernel and of its floor
    extra = (mlp.k9_launch_plan(batch[0].device, dims, b, p)[0],) if hasattr(
        mlp, "k9_launch_plan") else ()
    got = mlp.mlp_fit(keys, *batch, dims, steps, lr)
    row = {"digest": cs.params_digest(got)}
    if extra:
        row["cluster_ctas"] = extra[0]
    out = tuple(mlp.MLPLayer(torch.empty_like(l.w), torch.empty_like(l.b)) for l in got)
    args, keep = mlp.mlp_fit_args(keys, *batch, dims, steps, lr, 0.9, out, None, *extra)
    fn = kernels.launcher("mlp_fit")
    row["ms"] = cs.graph_ms(lambda: kernels.check(
        "mlp_fit", fn(*args, kernels.stream_handle(dev))), reps=10, rounds=3)
    row["digest_f27"] = cs.params_digest(mlp.mlp_fit(f27_keys, *f27, f27_dims, 32, lr))
    row["host_us"] = cs.host_us(lambda: mlp.mlp_fit(keys, *batch, dims, steps, lr),
                                calls=20, rounds=3)
    floor = kernels.launcher("mlp_fit_floor")
    row["floor_ms"] = cs.graph_ms(lambda: kernels.check("mlp_fit_floor", floor(
        p, b, len(dims) - 1, ctypes.addressof(keep[0]), *extra, kernels.stream_handle(dev))))
    del keep
    return {"mlp_fit": row}


def k10_runs(torch, cs, prep, dev) -> dict:
    """K10 of the tree on the path: timed and digested (see the docstring)."""
    from distributed_drift_detection_tpu_torch.models import mlp

    cfg, st = prep.config, prep.stream
    dims = cs.mlp_dims(st, cfg)
    _, keys = cs.mlp_keys(torch, prep, dev)
    batch = [torch.from_numpy(a).to(dev) for a in cs.k7_main_batch(prep.batches)]
    params = mlp.mlp_fit(keys, *batch, dims, cfg.fit_steps, cfg.mlp_learning_rate)
    p, n = cfg.partitions, cfg.window * cfg.per_batch
    T, Ty, idx = (torch.from_numpy(a).to(dev) for a in cs.k10_main_inputs(st, p, n))
    Tp = mlp.pad_row_table(T)
    err, pred = mlp.mlp_predict_err(params, Tp, Ty, idx, return_pred=True)
    row = {"digest": cs.k10_digest(pred, err)}
    ferr, fpred = mlp.mlp_predict_err(*cs.k10_f27_case(torch, mlp, dev), return_pred=True)
    row["digest_f27"] = cs.k10_digest(fpred, ferr)

    def call():
        return mlp.mlp_predict_err(params, Tp, Ty, idx)

    row["ms"] = cs.graph_ms(call, reps=10, rounds=3)
    row["host_us"] = cs.host_us(call)
    return {"mlp_predict_err": row}


def forest_runs(torch, cs, dev, only) -> dict:
    """K11 and K12 of the tree on the forest path (see the docstring)."""
    import hashlib
    import inspect

    from distributed_drift_detection_tpu_torch import api, config
    from distributed_drift_detection_tpu_torch.models import forest

    prep = api.prepare(config.RunConfig(**cs.SMOKE, model="forest"), device=dev)
    cfg, st = prep.config, prep.stream
    trees, depth, c = cfg.forest_trees, cfg.forest_depth, st.num_classes
    p, n = cfg.partitions, cfg.window * cfg.per_batch
    _, keys = cs.mlp_keys(torch, prep, dev)
    batch = [torch.from_numpy(a).to(dev) for a in cs.k7_main_batch(prep.batches)]

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    def fit():
        return forest.forest_fit(keys, *batch, trees, depth, c)

    params = fit()
    T, Ty, idx = (torch.from_numpy(a).to(dev) for a in cs.k10_main_inputs(st, p, n))
    Tp = forest.pad_row_table(T)
    # a tree whose K12 tallies C classes takes C
    kw = {"classes": c} if "classes" in inspect.signature(forest.forest_predict_err).parameters else {}

    def predict():
        return forest.forest_predict_err(params, Tp, Ty, idx, **kw)

    out = {}
    if only is None or "forest_fit" in only:
        out["forest_fit"] = {"digest": digest(*params), "ms": cs.graph_ms(fit),
                             "host_us": cs.host_us(fit)}
    if only is None or "forest_predict_err" in only:
        err, pred = forest.forest_predict_err(params, Tp, Ty, idx, return_pred=True, **kw)
        out["forest_predict_err"] = {"digest": digest(pred, err),
                                     "ms": cs.graph_ms(predict, reps=10, rounds=3),
                                     "host_us": cs.host_us(predict)}
    return out


def main() -> int:
    args = sys.argv[1:]
    if len(args) >= 2 and args[0] == "--one":
        only = set(args[2].split(",")) if len(args) > 2 else None
        print(json.dumps(one(args[1], only)))
        return 0
    only = None
    if args[:1] == ["--only"] and len(args) >= 2:
        only, args = args[1], args[2:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke

    print(chip_smoke.card())
    others = [os.path.abspath(a) for a in args]
    runs = []
    for root in others + [HERE, HERE] + others[::-1]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root]
            + ([only] if only else []),
            capture_output=True, text=True, timeout=600, cwd=HERE,
        )
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    summary = {}
    for label, root in [("this", HERE)] + [(o, o) for o in others]:
        mine = [r for r in runs if r["tree"] == root]
        summary[label] = {
            k: {m: (statistics.median(r[k][m] for r in mine)
                    if m.endswith(("ms", "us")) or m == "kernels"
                    else sorted({r[k][m] for r in mine}))
                for m in mine[0][k]}
            for k in mine[0] if k != "tree"
        }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
