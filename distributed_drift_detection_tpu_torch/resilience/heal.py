"""Sweep healing: the reference's ``missing_exps.sh`` made real — the
port's own copy of the JAX package's ``resilience/heal.py``.

The reference's only recovery from a crashed sweep is notebook cell 3:
count configs with fewer than 5 trials in the results CSV, hand-edit a
``missing_exps.sh`` of re-run commands, re-submit (SURVEY.md C14). Here
the same diff is a subcommand over first-class artifacts:

    python -m distributed_drift_detection_tpu_torch heal sweep.json \\
        --telemetry-dir runs/ [--json plan.json] [--script missing.sh] \\
        [--execute [--retries N] [--timeout-s S] [--device cuda|cpu]] \\
        [--cell KEY ...] [--scheduler HOST:PORT]

A **sweep spec** is the ``run_experiments.sh``-style grid as JSON —
``{"dataset": ..., "mults": [...], "partitions": [...], "models": [...],
"detectors": [...], "trials": N, "per_batch": B, "seed": S,
"results_csv": ...}`` — expanded through the same
:func:`..harness.grid.grid_configs` the sweep itself ran, so expected
cells and executed cells can never drift. Each expected trial's
**config digest** (``telemetry.registry.config_digest`` over
``config.telemetry_config_payload`` — byte-identical to what ``api.run``
recorded) is diffed against the registry's ``completed`` records:

* the **plan** (``--json``) lists every missing trial with its digest and
  config — machine-readable re-run intent;
* the **script** (``--script``) is the regenerated ``missing_exps.sh``:
  one idempotent shell line per missing trial (each re-invokes ``heal
  --execute --cell KEY``, so a half-run script re-run skips what landed);
* ``--execute`` runs the missing trials in-process under the supervisor
  (:func:`..resilience.supervisor.supervised_run` with a retry policy) on
  the card (``--device cpu`` for the plain path), bracketed by a
  ``kind="heal"`` registry record, until the sweep is whole;
* ``--scheduler HOST:PORT`` pushes the plan to a running ``sched/``
  scheduler instead (without torch, like plan mode): the scheduler's
  worker fleet runs the missing trials, and its exit code becomes the
  wholeness contract.

Completed trials are never re-run: the diff is against the registry, the
same source of truth ``watch``/``report --dir`` read. The digests are the
JAX package's byte for byte (``config.py`` is a verbatim copy), so either
package heals a sweep the other started. Plan mode imports no torch (it
runs wherever ``index.jsonl`` lands); only ``--execute`` reaches
``api.run``.

Exit code contract (scriptable wholeness check): ``0`` = sweep whole
(after executing, if asked), ``1`` = trials still missing.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time
from collections import Counter

from ..config import RunConfig, replace, telemetry_config_payload
from ..harness.grid import SWEEP_DEFAULTS, grid_configs, off_spec_reason
from ..telemetry import registry as run_registry
from .policy import RetryPolicy

# Spec keys beyond the required three, with their defaults — THE grid
# CLI's flag defaults (one shared constant, harness.grid.SWEEP_DEFAULTS):
# a spec omitting a knob must expand to the same configs the grid ran
# with the flag omitted, or digests drift.
_SPEC_DEFAULTS = SWEEP_DEFAULTS
_REQUIRED = ("dataset", "mults", "partitions")


def load_spec(path: str) -> dict:
    """Load and validate a sweep-spec JSON; unknown keys fail loudly (a
    typoed ``"model"`` silently healing the default sweep would be the
    exact class of bug this subsystem exists to prevent)."""
    with open(path) as fh:
        spec = json.load(fh)
    if not isinstance(spec, dict):
        raise ValueError(f"{path}: sweep spec must be a JSON object")
    missing = [k for k in _REQUIRED if k not in spec]
    if missing:
        raise ValueError(f"{path}: sweep spec missing required {missing}")
    unknown = set(spec) - set(_REQUIRED) - set(_SPEC_DEFAULTS)
    if unknown:
        raise ValueError(
            f"{path}: unknown sweep-spec key(s) {sorted(unknown)}; known: "
            f"{sorted(set(_REQUIRED) | set(_SPEC_DEFAULTS))}"
        )
    if spec.get("spec", "warn") not in ("warn", "skip", "off"):
        raise ValueError(f"{path}: spec must be 'warn', 'skip' or 'off'")
    return {**_SPEC_DEFAULTS, **spec}


def spec_configs(spec: dict) -> list[RunConfig]:
    """Expand a sweep spec into its trial configs — the exact expansion
    the sweep ran (``grid_configs``), including the ``spec='skip'``
    filtering: a cell the sweep never scheduled is not missing."""
    base = RunConfig(
        dataset=spec["dataset"],
        per_batch=int(spec["per_batch"]),
        seed=int(spec["seed"]),
        results_csv=spec["results_csv"],
        data_policy=str(spec["data_policy"]),
    )
    configs = grid_configs(
        base,
        mults=[float(m) for m in spec["mults"]],
        partitions=[int(p) for p in spec["partitions"]],
        models=list(spec["models"]),
        trials=int(spec["trials"]),
        detectors=list(spec["detectors"]),
    )
    if spec["spec"] == "skip":
        configs = [c for c in configs if off_spec_reason(c) is None]
    return configs


def completed_digests(telemetry_dir: str) -> Counter:
    """Multiset of config digests with a current ``completed`` status in
    the directory's registry (sweep/heal bracket records excluded) — the
    registry twin of ``harness.grid.completed_trials``'s CSV Counter."""
    return Counter(
        rec["config_digest"]
        for rec in run_registry.runs(telemetry_dir).values()
        if rec.get("kind") not in ("sweep", "heal")
        and rec.get("config_digest")
        and rec.get("status") == "completed"
    )


def sweep_plan(spec: dict, telemetry_dir: str) -> dict:
    """Diff the spec against the registry: which trials are still missing.

    Returns ``{"telemetry_dir", "cells_total", "completed", "missing":
    [{"app_name", "digest", "config"}, ...]}`` — ``missing`` preserves
    sweep order, and a digest completed N times covers at most N expected
    trials (the multiset decrement ``harness.grid.missing_configs`` uses
    on the CSV, here on the registry).
    """
    done = completed_digests(telemetry_dir)
    missing = []
    configs = spec_configs(spec)
    for cfg in configs:
        digest = run_registry.config_digest(telemetry_config_payload(cfg))
        if done[digest] > 0:
            done[digest] -= 1
        else:
            missing.append(
                {
                    "app_name": cfg.resolved_app_name(),
                    "digest": digest,
                    "config": telemetry_config_payload(cfg),
                }
            )
    return {
        "telemetry_dir": telemetry_dir,
        "cells_total": len(configs),
        "completed": len(configs) - len(missing),
        "missing": missing,
    }


def write_plan_json(plan: dict, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(plan, fh, indent=2, sort_keys=True)
        fh.write("\n")


def write_plan_script(
    plan: dict,
    spec_path: str,
    path: str,
    *,
    retries: "int | None" = None,
    timeout_s: "float | None" = None,
    device: str = "cuda",
) -> None:
    """Write the re-run plan as a shell script — ``missing_exps.sh`` with
    the hand-editing replaced by artifacts. Each line re-runs exactly one
    missing trial via ``heal --execute --cell``, so the script is
    idempotent: re-running it after a partial pass skips trials whose
    completed record already landed. ``retries``/``timeout_s`` ride onto
    every generated line (the CLI passes its own flags through), so the
    operator's retry budget survives into the script's execution; so does
    a ``device`` other than the card."""
    extra = ""
    if retries is not None:
        extra += f" --retries {int(retries)}"
    if timeout_s:
        extra += f" --timeout-s {float(timeout_s)}"
    if device != "cuda":
        extra += f" --device {device}"
    lines = [
        "#!/bin/sh",
        "# Generated by `python -m distributed_drift_detection_tpu_torch heal`"
        " — the reference's",
        f"# missing_exps.sh (SURVEY.md C14) for {len(plan['missing'])} "
        f"missing of {plan['cells_total']} trials.",
        "set -e",
    ]
    for cell in plan["missing"]:
        lines.append(
            f"python -m distributed_drift_detection_tpu_torch heal "
            f"{shlex.quote(spec_path)} "
            f"--telemetry-dir {shlex.quote(plan['telemetry_dir'])} "
            f"--execute --cell {shlex.quote(cell['app_name'])}{extra}"
        )
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    os.chmod(path, 0o755)


def submit_to_scheduler(spec: dict, plan: dict, addr: str) -> dict:
    """Submit the plan's missing cells to a running ``sched/`` scheduler
    over the control protocol (no torch) — heal's push-mode alternative to
    emitting a shell script: the scheduler's worker fleet runs the
    missing trials instead of this process. The wire cells are built
    through the same ``cell_to_wire`` the scheduler's own spec expansion
    uses, so a heal-submitted cell and a spec-expanded cell are
    byte-identical (digest and all). Returns the scheduler's ack
    (``queued``/``duplicates`` counts — resubmitting a plan is
    idempotent, like re-running the generated script)."""
    from ..sched.protocol import ControlClient, cell_to_wire, parse_addr

    by_name = {cfg.resolved_app_name(): cfg for cfg in spec_configs(spec)}
    wires = [
        cell_to_wire(by_name[cell["app_name"]], digest=cell["digest"])
        for cell in plan["missing"]
    ]
    host, port = parse_addr(addr)
    with ControlClient(host, port) as client:
        return client.request({"op": "submit", "cells": wires})


def execute(
    spec: dict,
    telemetry_dir: str,
    *,
    policy: RetryPolicy = RetryPolicy(),
    only: "set[str] | None" = None,
    progress=print,
    device="cuda",
) -> int:
    """Run the sweep's missing trials under the supervisor on ``device``
    (the card by default); returns the number executed. ``only`` restricts to the named cells: a name whose
    trial already completed is skipped with a note (the idempotent
    contract the generated script relies on), but a name the sweep spec
    does not contain at all raises — a typoed ``--cell`` must not read as
    healed. The whole pass is bracketed by a ``kind="heal"`` registry
    record, so a crashed heal is itself visible fleet state.
    """
    from .supervisor import supervised_run  # lazy: pulls in api and torch

    plan = sweep_plan(spec, telemetry_dir)
    targets = plan["missing"]
    by_name = {cfg.resolved_app_name(): cfg for cfg in spec_configs(spec)}
    if only is not None:
        unknown = only - set(by_name)
        if unknown:
            raise ValueError(
                f"cell(s) {sorted(unknown)} are not in the sweep spec — "
                "check --cell against the plan's app names"
            )
        missing_names = {c["app_name"] for c in targets}
        for name in sorted(only - missing_names):
            progress(f"heal: cell {name!r} already completed — skipping")
        targets = [c for c in targets if c["app_name"] in only]
    if not targets:
        progress("heal: sweep is whole — nothing to run")
        return 0
    heal_id = f"heal-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
    run_registry.record(
        telemetry_dir, heal_id, "running", kind="heal",
        trials_to_run=len(targets),
    )
    try:
        for i, cell in enumerate(targets):
            cfg = replace(
                by_name[cell["app_name"]], telemetry_dir=telemetry_dir
            )
            res = supervised_run(cfg, policy, device=device)
            progress(
                f"heal [{i + 1}/{len(targets)}] {cell['app_name']}: "
                f"time={res.total_time:.2f}s "
                f"detections={res.metrics.num_detections}"
            )
    except BaseException:
        try:
            run_registry.record(telemetry_dir, heal_id, "failed", kind="heal")
        except Exception:
            pass  # best-effort: the heal's own error must surface
        raise
    run_registry.record(
        telemetry_dir, heal_id, "completed", kind="heal",
        trials_run=len(targets),
    )
    return len(targets)


def main(argv=None, device: str = "cuda") -> None:
    """The ``heal`` subcommand; ``device`` is ``--device``'s default."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch heal",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("spec", help="sweep-spec JSON (the grid as data)")
    ap.add_argument(
        "--telemetry-dir", required=True, metavar="DIR",
        help="telemetry directory whose registry records the sweep",
    )
    ap.add_argument(
        "--json", default=None, metavar="PATH",
        help="write the re-run plan as JSON",
    )
    ap.add_argument(
        "--script", default=None, metavar="PATH",
        help="write the re-run plan as an idempotent shell script "
        "(the regenerated missing_exps.sh)",
    )
    ap.add_argument(
        "--execute", action="store_true",
        help="run the missing trials under the supervisor until the "
        "sweep is whole",
    )
    ap.add_argument(
        "--scheduler", default=None, metavar="ADDR",
        help="submit the missing-cell plan to a running sched/ scheduler "
        "at HOST:PORT instead of running anything here (no torch, like "
        "plan mode); exits 0 once the submission is accepted — the "
        "scheduler's own exit code is then the wholeness contract",
    )
    ap.add_argument(
        "--cell", action="append", default=None, metavar="KEY",
        help="with --execute: restrict to this cell (repeatable; the "
        "generated script uses one per line)",
    )
    ap.add_argument(
        "--retries", type=int, default=2,
        help="supervised retries per trial on transient failure "
        "(default 2)",
    )
    ap.add_argument(
        "--timeout-s", type=float, default=0.0,
        help="per-attempt wall-clock budget in seconds (0 = unlimited)",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default=device,
        help=f"with --execute: where the trials run (default {device})",
    )
    args = ap.parse_args(argv)

    spec = load_spec(args.spec)
    if args.cell:
        known = {cfg.resolved_app_name() for cfg in spec_configs(spec)}
        unknown = set(args.cell) - known
        if unknown:
            raise SystemExit(
                f"heal: cell(s) {sorted(unknown)} are not in the sweep "
                "spec — check --cell against the plan's app names"
            )
    plan = sweep_plan(spec, args.telemetry_dir)
    print(
        f"sweep: {plan['cells_total']} trials, {plan['completed']} "
        f"completed, {len(plan['missing'])} missing"
    )
    for cell in plan["missing"]:
        print(f"  missing {cell['app_name']}  (digest {cell['digest']})")
    if args.json:
        write_plan_json(plan, args.json)
        print(f"plan JSON → {args.json}")
    if args.script:
        write_plan_script(
            plan, args.spec, args.script,
            retries=args.retries, timeout_s=args.timeout_s or None,
            device=args.device,
        )
        print(f"re-run script → {args.script}")
    if args.scheduler:
        if args.execute:
            raise SystemExit(
                "heal: --scheduler and --execute are mutually exclusive "
                "(push the plan to the fleet OR run it here, not both)"
            )
        if plan["missing"]:
            ack = submit_to_scheduler(spec, plan, args.scheduler)
            print(
                f"submitted {ack.get('queued', 0)} cell(s) to scheduler "
                f"{args.scheduler} ({ack.get('duplicates', 0)} already "
                "queued there)"
            )
        else:
            print("sweep is whole — nothing to submit")
        raise SystemExit(0)
    if args.execute and plan["missing"]:
        policy = RetryPolicy(
            max_attempts=max(args.retries, 0) + 1,
            timeout_s=args.timeout_s or None,
        )
        execute(
            spec,
            args.telemetry_dir,
            policy=policy,
            only=set(args.cell) if args.cell else None,
            device=args.device,
        )
        plan = sweep_plan(spec, args.telemetry_dir)
        print(
            f"after heal: {plan['completed']}/{plan['cells_total']} "
            f"completed, {len(plan['missing'])} missing"
        )
    still_missing = {c["app_name"] for c in plan["missing"]}
    if args.cell:
        # Scoped invocation (one generated-script line): the exit code
        # judges only the requested cells, or `set -e` would abort the
        # script on every line but the last.
        still_missing &= set(args.cell)
    raise SystemExit(0 if not still_missing else 1)


if __name__ == "__main__":
    main(sys.argv[1:])
