"""Experiment grid harness (reference C12, ``run_experiments.sh``) — the
port's twin of the JAX package's ``harness/grid.py``.

The reference sweeps (data multiplier × instances × memory × cores) via a
bash loop re-invoking the whole script, with a companion notebook cell that
regenerates a ``missing_exps.sh`` for configs that lost trials to crashes
(C14, the repo's only fault-tolerance mechanism). Here the sweep is a
library/CLI function with the crash-recovery semantics built in: the grid is
*idempotent* — it counts completed trials per config in the results CSV and
only runs the missing ones, so re-running after a crash resumes exactly
(replacing the generated-bash-script dance; fixes quirk #2, the
``DDM_process.py`` case mismatch, by not shelling out at all).

The trial keys, the ``Spark App`` names and the results CSV are the JAX
package's byte for byte, so a CSV written by either package resumes in the
other. Every trial runs on the card (``run_grid(device=...)`` takes
another device). ``telemetry_dir`` gives every trial its run log and
registry records, and the sweep a ``kind="sweep"`` bracket, and
``profile_dir`` a ``torch.profiler`` capture of each trial's Final Time
span, as in the JAX package.

Usage::

    python -m distributed_drift_detection_tpu_torch.harness.grid \
        --dataset outdoorStream.csv \
        --mults 64,128 --partitions 1,2,4,8,16 --trials 5
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
from collections import Counter

from ..config import (
    AUTO_POLICY_VERSION,
    DATA_POLICIES,
    DETECTOR_NAMES,
    RunConfig,
    replace,
    resolve_retrain_threshold,
)
from ..resilience import faults
from ..resilience.policy import RetryPolicy
from ..results import read_results

# Sweep-shape defaults, shared between this CLI's argparse flags and the
# sweep-spec schema (the JAX package's resilience.heal reads it): a spec
# that omits a knob must expand to the SAME configs the grid CLI ran with
# the flag omitted, or the config digests drift and a heal re-runs (or
# wrongly skips) completed trials. `seed` is the RunConfig default (the
# grid CLI exposes no flag for it).
SWEEP_DEFAULTS = {
    "models": ["centroid"],
    "detectors": ["ddm"],
    "trials": 5,
    "per_batch": 100,
    "seed": 0,
    "results_csv": "ddm_cluster_runs.csv",
    "spec": "warn",
    "data_policy": "strict",
}


def sweep_spec(dataset: str, mults, partitions, **knobs) -> dict:
    """The sweep **as data**: the spec JSON ``heal`` diffs and the
    ``sched/`` scheduler expands (the JAX package's
    ``resilience.heal.load_spec`` is the reader; this is a writer). Unknown
    knobs fail loudly — the same typo posture as the reader — and every
    omitted knob is filled from :data:`SWEEP_DEFAULTS`, so a spec written
    here expands to exactly the configs the grid CLI would run with those
    flags."""
    unknown = set(knobs) - set(SWEEP_DEFAULTS)
    if unknown:
        raise ValueError(
            f"unknown sweep knob(s) {sorted(unknown)}; known: "
            f"{sorted(SWEEP_DEFAULTS)}"
        )
    return {
        "dataset": str(dataset),
        "mults": [float(m) for m in mults],
        "partitions": [int(p) for p in partitions],
        **SWEEP_DEFAULTS,
        **knobs,
    }


def grid_configs(
    base: RunConfig,
    mults: list[float],
    partitions: list[int],
    models: list[str] | None = None,
    trials: int = 5,
    detectors: list[str] | None = None,
) -> list[RunConfig]:
    """All (mult × partitions × model × detector × trial) configs."""
    models = models or [base.model]
    detectors = detectors or [base.detector]
    out = []
    for m, p, mod, det, t in itertools.product(
        mults, partitions, models, detectors, range(trials)
    ):
        cfg = replace(
            base,
            mult_data=m,
            partitions=p,
            model=mod,
            detector=det,
            seed=base.seed + t,
        )
        out.append(replace(cfg, time_string=f"{_config_key(cfg)}-t{t}"))
    return out


def _config_key(cfg: RunConfig) -> str:
    """Trial-identity key for crash recovery: every knob that changes the
    result must appear, else a re-run with a changed knob silently skips
    trials recorded under the old settings."""
    if cfg.detector not in DETECTOR_NAMES:
        raise ValueError(
            f"unknown detector {cfg.detector!r}; expected one of {DETECTOR_NAMES}"
        )
    # Key on the *resolved* guard (RETRAIN_AUTO → per-family value): the key
    # must name what actually runs, so the auto default keeps non-guarded
    # families' completed trials valid while retiring guarded families'
    # pre-guard rows. 0.0 is an active setting; None resolves to no segment.
    rthr = resolve_retrain_threshold(cfg)
    thr = f"-r{rthr}" if rthr is not None else ""
    # The execution policy is part of every trial's identity: window and
    # speculation depth change the recorded Final Time for every model (the
    # grid's primary result column) and additionally the flags for
    # key-consuming fits (mlp/rf draw PRNG keys per window/level —
    # config.py's 'seed-equivalent but not bit-equal' caveat). Keying the
    # raw values means a *default change* (e.g. the r04 move 16×1 → auto)
    # retires old rows instead of silently resuming onto their timings —
    # the exact hazard this docstring warns about. Auto-mode keys (0
    # sentinels) additionally embed config.AUTO_POLICY_VERSION, because
    # '0' names the sentinel, not what it resolves to: a change to the
    # resolution *algorithm* must retire auto-mode rows too. Explicit pins
    # are self-describing and stay unversioned.
    win = f"-w{cfg.window}r{cfg.window_rotations}"
    if cfg.window == 0 or cfg.window_rotations == 0:
        win += f"v{AUTO_POLICY_VERSION}"
    if cfg.data_policy not in DATA_POLICIES:
        raise ValueError(
            f"unknown data_policy {cfg.data_policy!r}; expected one of "
            f"{DATA_POLICIES}"
        )
    # Non-default data policies change which rows reach the detector on a
    # dirty stream, so they are trial identity; the default stays
    # unsegmented so pre-policy completed trials remain valid.
    dp = "" if cfg.data_policy == "strict" else f"-dp{cfg.data_policy}"
    # The detector segment carries the active statistic's name + full
    # parameter tuple; non-DDM detectors embed only their own params — the
    # DDM tuple is inert for them and must not invalidate completed trials.
    # (Pre-r04 rows are all retired anyway by the W×R segment above — the
    # r04 default-policy change altered every trial's timing — so the
    # detector segment's job is only to keep *future* keys stable.)
    if cfg.detector == "ddm":
        d = cfg.ddm
        det = f"ddm{d.min_num_instances}_{d.warning_level}_{d.out_control_level}"
        if d.noise_floor:  # suffix only when active: pre-floor keys unchanged
            det += f"f{d.noise_floor}"
    else:
        det = cfg.detector + "_".join(
            str(v) for v in getattr(cfg, cfg.detector)
        )
    return (
        f"m{cfg.mult_data}-p{cfg.partitions}-{cfg.model}-b{cfg.per_batch}"
        f"{win}-{det}-s{cfg.seed}{thr}{dp}"
    )


def off_spec_reason(cfg: RunConfig) -> str | None:
    """The notebook's per-dataset grid-validity rule (C13/C14).

    ``Plot Results.ipynb`` cell 3 refuses to schedule missing trials for
    off-spec cells: outdoorStream only at ``Data Multiplier >= 64`` and
    ``Instances <= 16``; rialto-like streams at any ``mult >= 1``. The rule
    was convention in the reference (hand-enforced when regenerating
    ``missing_exps.sh``); here it is code, so an off-spec sweep is a choice
    (``spec='off'``), not an accident. Returns a human-readable reason when
    ``cfg`` falls outside its dataset's published grid, else ``None`` —
    including for datasets the notebook published no grid for (a user's own
    CSV sweeps whatever it likes, e.g. the supported ``mult_data < 1``
    subsampling mode).
    """
    name = os.path.basename(str(cfg.dataset))
    if name.startswith("outdoorStream"):
        if cfg.mult_data < 64:
            return (
                f"outdoorStream grid starts at mult_data=64 (got "
                f"{cfg.mult_data}; Plot Results.ipynb cell 3)"
            )
        if cfg.partitions > 16:
            return (
                f"outdoorStream grid caps partitions at 16 (got "
                f"{cfg.partitions}; Plot Results.ipynb cell 3)"
            )
    elif name.startswith("rialto") or str(cfg.dataset).startswith("synth:rialto"):
        # prefix, not equality: parameterized synth specs
        # ('synth:rialto,seed=1', io/stream.py) are the same published grid
        if cfg.mult_data < 1:
            return (
                f"rialto grid requires mult_data >= 1 (got {cfg.mult_data}; "
                "Plot Results.ipynb cell 3)"
            )
    return None


def completed_trials(results_csv: str) -> Counter:
    """Count completed trials per config key from the results CSV (the C13
    trial count / C14 missing-trial detection, done on live data).

    Torn-tail tolerant: a sweep killed mid-append leaves at most one
    partial trailing row, and the resume that healing exists for must not
    choke on exactly the artifact a crash produces."""
    try:
        rows = read_results(results_csv, allow_partial_tail=True)
    except FileNotFoundError:
        return Counter()
    return Counter(r["Spark App"] for r in rows)


def missing_configs(configs: list[RunConfig]) -> list[RunConfig]:
    """Crash recovery (C14): configs whose trial row is not yet in the CSV."""
    if not configs:
        return []
    done = completed_trials(configs[0].results_csv)
    todo = []
    for cfg in configs:
        key = cfg.resolved_app_name()
        if done[key] > 0:
            done[key] -= 1
        else:
            todo.append(cfg)
    return todo


def run_grid(
    base: RunConfig,
    mults: list[float],
    partitions: list[int],
    models: list[str] | None = None,
    trials: int = 5,
    progress=print,
    detectors: list[str] | None = None,
    warmup: bool = False,
    spec: str = "warn",
    telemetry_dir: str = "",
    profile_dir: str = "",
    retries: int = 0,
    timeout_s: float | None = None,
    on_error: str = "fail",
    device="cuda",
) -> int:
    """Run all missing trials of the sweep on ``device``; returns the
    number executed.

    ``warmup=True`` executes one *unrecorded* run before each config's first
    timed trial, so every recorded ``Final Time`` is warm — the kernels'
    build and first-touch device setup stay out of the 5-trial means,
    matching the reference's warm-cluster methodology (its numbers exclude
    cluster start-up; trials are config-major, so one warm run covers the
    whole trial block).

    ``spec`` applies the notebook's per-dataset grid-validity rule
    (:func:`off_spec_reason`): ``'warn'`` (default) runs off-spec cells but
    flags each once via ``progress``; ``'skip'`` drops them from the sweep;
    ``'off'`` disables the check entirely.

    Every trial runs under the supervisor — ``retries`` transient-failure
    re-runs per cell with deterministic seeded backoff and ``timeout_s``
    per-attempt wall-clock budget (``RetryPolicy``).
    ``on_error='continue'`` keeps sweeping past a cell whose attempts all
    failed: remaining cells run, each failure is reported via
    ``progress``, and a summary ``RuntimeError`` is raised at the end
    (re-run the grid to finish the sweep). The default ``'fail'`` stops at
    the first failed cell, matching the reference's crash behaviour.
    ``run_grid`` also arms any fault sites requested via the ``DDD_FAULTS``
    env var (``resilience.faults.arm_from_env``) — inert unless set.

    ``telemetry_dir`` gives every executed trial its own JSONL run log in
    that directory (the filename embeds the cell's config key) and its
    ``index.jsonl`` records (``api.run``: running → completed/failed), and
    the sweep itself writes a bracketing ``kind="sweep"`` record with its
    trial totals — what ``heal`` diffs a sweep spec against. Warm-up runs
    stay untelemetered (they are unrecorded by design).

    ``profile_dir`` wraps every executed trial's Final Time span in a
    ``torch.profiler`` capture under that directory (one timestamped
    session subdirectory a trial — ``RunConfig.profile_dir``). Profiling
    perturbs the very Final Times the grid records, so use it on
    diagnostic sweeps. Warm-ups stay unprofiled, like telemetry.
    """
    if spec not in ("warn", "skip", "off"):
        raise ValueError(f"spec must be 'warn', 'skip' or 'off', got {spec!r}")
    if on_error not in ("fail", "continue"):
        raise ValueError(
            f"on_error must be 'fail' or 'continue', got {on_error!r}"
        )

    from ..api import run  # lazy: keeps the harness importable without torch
    from ..resilience.supervisor import supervise

    armed = faults.arm_from_env()
    if armed:
        progress(f"grid: fault site(s) armed from DDD_FAULTS: {armed}")
    policy = RetryPolicy(
        max_attempts=max(retries, 0) + 1, timeout_s=timeout_s, seed=base.seed
    )

    configs = grid_configs(base, mults, partitions, models, trials, detectors)
    if spec != "off":
        flagged: set[str] = set()
        kept = []
        for cfg in configs:
            reason = off_spec_reason(cfg)
            if reason is None:
                kept.append(cfg)
                continue
            if reason not in flagged:
                flagged.add(reason)
                verb = "skipping" if spec == "skip" else "off-spec"
                progress(f"grid {verb}: {reason}")
            if spec == "warn":
                kept.append(cfg)
        configs = kept
    todo = missing_configs(configs)
    progress(f"grid: {len(configs)} trials total, {len(todo)} to run")

    failures: list[tuple[str, Exception]] = []
    # The sweep's registry bracket: "a sweep is running here, N trials to
    # go" (per-trial records are api.run's). A crashed sweep reads as
    # failed next to however many trial records it got through.
    sweep_id = None
    if telemetry_dir:
        import time

        from ..telemetry import registry as run_registry

        sweep_id = f"sweep-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
        run_registry.record(
            telemetry_dir, sweep_id, "running", kind="sweep",
            trials_total=len(configs), trials_to_run=len(todo),
        )
    try:
        warmed = None
        for i, cfg in enumerate(todo):
            static_key = (
                cfg.dataset, cfg.mult_data, cfg.partitions, cfg.model,
                cfg.detector, cfg.per_batch, cfg.window, cfg.window_rotations,
            )
            if telemetry_dir:
                cfg = replace(cfg, telemetry_dir=telemetry_dir)
            if profile_dir:
                cfg = replace(cfg, profile_dir=profile_dir)
            key = cfg.resolved_app_name()

            # The fault site lives INSIDE the supervised attempt, so a
            # positional arming (`at=K`) fires once and the retry heals it
            # — the deterministic stand-in for a transient crash.
            def attempt(cfg=cfg, i=i, key=key):
                faults.fire("grid.cell", index=i, key=key)
                return run(cfg, device=device)

            try:
                # The warm-up runs OUTSIDE the supervised attempt: it must
                # not be charged against the per-attempt timeout budget or
                # repeated per retry (its whole point is once per config
                # block), and it records nothing: no CSV row, no run log,
                # no profile capture.
                if warmup and static_key != warmed:
                    run(replace(cfg, results_csv="", time_string="warmup",
                                telemetry_dir=None, profile_dir=""), device=device)
                    warmed = static_key
                res = supervise(attempt, policy, telemetry_dir=telemetry_dir, name=key)
            except Exception as exc:
                if on_error != "continue":
                    raise
                failures.append((key, exc))
                progress(
                    f"[{i + 1}/{len(todo)}] {key}: FAILED "
                    f"({type(exc).__name__}: {exc}) — continuing"
                )
                continue
            progress(
                f"[{i + 1}/{len(todo)}] {key}: "
                f"time={res.total_time:.2f}s detections={res.metrics.num_detections} "
                f"delay={res.metrics.mean_delay_rows:.1f} rows"
            )
    except BaseException:
        if sweep_id is not None:
            try:
                run_registry.record(telemetry_dir, sweep_id, "failed", kind="sweep")
            except Exception:
                pass  # best-effort: the sweep's own error must surface
        raise
    if sweep_id is not None:
        run_registry.record(
            telemetry_dir, sweep_id,
            "failed" if failures else "completed", kind="sweep",
            trials_run=len(todo) - len(failures),
            trials_failed=len(failures),
        )
    if failures:
        # The sweep finished its schedule but is not whole: fail loudly
        # instead of returning a count that reads as success
        # (on_error='fail' never reaches here).
        raise RuntimeError(
            f"{len(failures)} of {len(todo)} trials failed "
            f"({', '.join(k for k, _ in failures)}); the registry/CSV have "
            "the evidence — re-run the grid or `heal --execute` to finish"
        )
    return len(todo)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default=RunConfig.dataset)
    ap.add_argument("--mults", default="1,2,4")
    ap.add_argument("--partitions", default="1,2,4,8")
    ap.add_argument("--models", default=",".join(SWEEP_DEFAULTS["models"]))
    ap.add_argument("--detectors", default=",".join(SWEEP_DEFAULTS["detectors"]))
    ap.add_argument("--trials", type=int, default=SWEEP_DEFAULTS["trials"])
    ap.add_argument("--per-batch", type=int, default=SWEEP_DEFAULTS["per_batch"])
    ap.add_argument("--results-csv", default=SWEEP_DEFAULTS["results_csv"])
    ap.add_argument(
        "--warmup",
        action="store_true",
        help="one unrecorded warm run before each config's timed trials "
        "(warm-only Final Times; see run_grid)",
    )
    ap.add_argument(
        "--spec",
        default=SWEEP_DEFAULTS["spec"],
        choices=["warn", "skip", "off"],
        help="notebook grid-validity rule (off_spec_reason): warn on "
        "off-spec (dataset, mult, partitions) cells, skip them, or disable "
        "the check",
    )
    ap.add_argument(
        "--data-policy",
        default=SWEEP_DEFAULTS["data_policy"],
        choices=list(DATA_POLICIES),
        help="ingest contract policy for dirty CSVs (io.sanitize): strict "
        "= fail loudly on the first violating row; quarantine = mask "
        "violating rows (quarantine.jsonl sidecar) and continue; repair "
        "= impute NaN cells / clamp labels, quarantining the rest",
    )
    ap.add_argument(
        "--telemetry-dir",
        default="",
        help="per-trial JSONL run logs and registry records into this "
        "directory (what `heal` diffs the sweep spec against)",
    )
    ap.add_argument(
        "--compile-cache-dir",
        default="",
        help="directory the hand-written kernels and the native CSV parser "
        "are built into and loaded from (RunConfig.compile_cache_dir): "
        "sweeps repeated across invocations run no nvcc (warm-start)",
    )
    ap.add_argument(
        "--profile-dir",
        default="",
        help="a torch.profiler capture of each trial's Final Time span: one "
        "timestamped session directory of Chrome traces a trial",
    )
    ap.add_argument(
        "--retries",
        type=int,
        default=0,
        help="supervised re-runs per trial on transient failure "
        "(resilience.RetryPolicy; deterministic seeded backoff)",
    )
    ap.add_argument(
        "--timeout-s",
        type=float,
        default=0.0,
        help="per-attempt wall-clock budget in seconds (0 = unlimited)",
    )
    ap.add_argument(
        "--continue-on-error",
        action="store_true",
        help="keep sweeping past a failed cell; the sweep exits nonzero "
        "at the end with the failed cells listed (a re-run finishes it)",
    )
    ap.add_argument(
        "--spec-out",
        default="",
        metavar="PATH",
        help="also write this sweep as a spec JSON (sweep_spec) — the "
        "artifact `heal` diffs and the sched/ scheduler re-runs, so the "
        "exact grid is recoverable without reconstructing the flags",
    )
    args = ap.parse_args(argv)

    if args.spec_out:
        import json

        spec = sweep_spec(
            args.dataset,
            [float(m) for m in args.mults.split(",")],
            [int(p) for p in args.partitions.split(",")],
            models=args.models.split(","),
            detectors=args.detectors.split(","),
            trials=args.trials,
            per_batch=args.per_batch,
            results_csv=args.results_csv,
            spec=args.spec,
            data_policy=args.data_policy,
        )
        with open(args.spec_out, "w") as fh:
            json.dump(spec, fh, indent=2, sort_keys=True)
            fh.write("\n")

    base = RunConfig(
        dataset=args.dataset,
        per_batch=args.per_batch,
        results_csv=args.results_csv,
        data_policy=args.data_policy,
        compile_cache_dir=args.compile_cache_dir,
    )
    run_grid(
        base,
        mults=[float(m) for m in args.mults.split(",")],
        partitions=[int(p) for p in args.partitions.split(",")],
        models=args.models.split(","),
        trials=args.trials,
        detectors=args.detectors.split(","),
        warmup=args.warmup,
        spec=args.spec,
        telemetry_dir=args.telemetry_dir,
        profile_dir=args.profile_dir,
        retries=args.retries,
        timeout_s=args.timeout_s or None,
        on_error="continue" if args.continue_on_error else "fail",
    )


if __name__ == "__main__":
    main(sys.argv[1:])
