"""Detection-delay parity harness: the "≤ 1-batch change" acceptance proof
— the port's twin of the JAX package's ``harness/parity.py``.

The north star (BASELINE.json) requires the TPU-native model families to
match the reference's detection delay within one batch. The reference
published no recoverable delay numbers (SURVEY.md §6: its runs CSV is not
committed), so the baseline is this framework's own ``model='rf'`` — the
same model family, hyper-parameters and loop as the reference's workers
(sklearn RandomForest via host callback, ``models/rf.py``; reference
``DDM_Process.py:96-105``).

Methodology mirrors the reference's trial harness (``Plot Results.ipynb``
cell 0: ≥5 trials per config, mean/variance): each model runs the same
planted-drift stream over N seeds; the statistic is ``mean_delay_batches``
in **global-batch units** (one global batch = ``per_batch`` rows of the
merged stream). One *worker*-batch spans ``partitions × per_batch`` rows
= ``partitions`` global units, so the acceptance criterion is

    delay(model) − delay(rf) ≤ partitions   (global-batch units)

one-sided: a family may detect *earlier* than the RF baseline by any margin
(an improvement, not a parity failure — the north star bounds degradation),
but no more than one worker-batch later.

Delay alone is gameable — a family that fires more often looks "earlier"
on mean delay while spraying extra detections. Each run is therefore also
decomposed against the planted boundaries
(``metrics.attribution_metrics``): detections split into per-(partition,
boundary) *first hits* (reported with their own hit-based delay) and
*spurious* extra fires, with a second acceptance axis bounding
spurious-rate inflation vs rf (:func:`check_spurious`,
``SPURIOUS_TOLERANCE``) — the reference's merge contract is about *which*
changes are found (``DDM_Process.py:89-92``), not just how late.

Run ``python -m distributed_drift_detection_tpu_torch.harness.parity`` to
measure the table on the card (``--device cpu`` runs in-process on the CPU,
where the rf baseline's scikit-learn is; the card's machine has none) and
print the PARITY.md summary table; ``tests/test_torch_harness.py`` holds
its rows against the JAX package's at CI size.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import sys
from typing import NamedTuple

FIELDS = [
    "model",
    "seed",
    "mean_delay_batches",
    "mean_delay_rows",
    "detections",
    # Boundary attribution (metrics.attribution_metrics): decomposes
    # `detections` into first hits on planted boundaries vs spurious extra
    # fires, so "earlier" can't be bought by firing more often.
    "hits",
    "misses",
    "spurious",
    "precision",
    "recall",
    "first_hit_delay_batches",  # mean first-hit delay, global-batch units
    "partitions",
    "per_batch",
    "mult_data",
    "dataset",
]

# Model specs: a bare family name, or ``family@variant`` selecting a shipped
# preset (the ``model`` CSV column records the full spec). Variants:
#   @robust — detector preset ``config.DDM_ROBUST`` (band-width noise floor
#   at the reference's REGRESSION_THRESH constant): the shipped config for
#   residual-error families — ``linear``'s documented over-firing fix
#   (VERDICT r4 #5; measured in the committed artifact's linear@robust rows).
DEFAULT_MODELS = (
    "rf", "centroid", "gnb", "mlp", "linear", "forest", "linear@robust",
)

# The acceptance gate (``report(required=...)``) covers every shipped
# on-device family (VERDICT r4 #1 — the flagship-only gate let silent
# failures ship). Documented, tested opt-outs:
#   * ``linear`` at the reference's raw 3/0.5/1.5 sensitivity — measured
#     over-firing on rialto-like regimes (PARITY.md); its gated
#     configuration is ``linear@robust`` (the shipped preset above).
#   * ``majority`` — golden-oracle family, not part of the parity sweep
#     (bit-exact tests in tests/test_engine.py are its acceptance).
#   * ``rf`` — the baseline itself.
REQUIRED_MODELS = ("centroid", "gnb", "mlp", "forest", "linear@robust")

# The two benchmark geometries of the committed artifact (VERDICT r3 #3/#4:
# parity must hold on the reference's *primary published dataset*, not only
# the rialto stand-in). outdoorStream is read from the working directory
# (RunConfig's default dataset; the JAX package reads it from the
# reference's checkout); mult=64 is the smallest on-spec cell of the
# notebook grid (harness.grid.off_spec_reason), p=8 keeps the geometry of
# the artifact. Format: (dataset, mult_data, partitions).
DEFAULT_GEOMETRIES = (
    ("synth:rialto", 4.0, 8),
    ("outdoorStream.csv", 64.0, 8),
)

# Acceptance bound on spurious-rate inflation vs the rf baseline
# (check_spurious): at most 15 percentage points more of a model's
# detections may be non-first fires than rf's on the same streams.
SPURIOUS_TOLERANCE = 0.15


def measure_delay_parity(
    models=DEFAULT_MODELS,
    dataset: str = "synth:rialto",
    mult_data: float = 4.0,
    partitions: int = 8,
    per_batch: int = 100,
    seeds=range(5),
    rf_estimators: int = 100,
    progress=None,
    device="cuda",
) -> list[dict]:
    """Per-(model, seed) delay rows for the parity table, each run on
    ``device``.

    The stream geometry is identical across models and varies only by seed
    (``RunConfig.seed`` drives the duplicate-shuffle, the stripe-time batch
    shuffle and every model's fit keys), so differences are attributable to
    the model family alone — the comparison the criterion needs.
    """
    from ..api import run
    from ..config import RunConfig, parse_model_spec
    from ..metrics import attribution_metrics

    rows = []
    for model in models:
        family, extra = parse_model_spec(model)
        for seed in seeds:
            cfg = RunConfig(
                dataset=dataset,
                mult_data=mult_data,
                partitions=partitions,
                per_batch=per_batch,
                model=family,
                seed=seed,
                rf_estimators=rf_estimators,
                results_csv="",
                **extra,
            )
            res = run(cfg, device=device)
            m = res.metrics
            a = attribution_metrics(
                res.flags.change_global,
                res.stream.dist_between_changes,
                res.stream.num_rows,
            )
            rows.append(
                {
                    "model": model,
                    "seed": seed,
                    "mean_delay_batches": round(m.mean_delay_batches, 4),
                    "mean_delay_rows": round(m.mean_delay_rows, 2),
                    "detections": m.num_detections,
                    "hits": a.hits,
                    "misses": a.misses,
                    "spurious": a.spurious,
                    "precision": round(a.precision, 4),
                    "recall": round(a.recall, 4),
                    "first_hit_delay_batches": round(
                        a.mean_first_hit_delay_rows / per_batch, 4
                    ),
                    "partitions": partitions,
                    "per_batch": per_batch,
                    "mult_data": mult_data,
                    "dataset": dataset,
                }
            )
            if progress is not None:
                progress(
                    f"{model} seed={seed}: delay={m.mean_delay_batches:.2f} "
                    f"global batches (first-hit "
                    f"{a.mean_first_hit_delay_rows / per_batch:.2f}), "
                    f"detections={m.num_detections} = {a.hits} hits + "
                    f"{a.spurious} spurious, recall={a.recall:.3f}"
                )
    return rows


def group_by_geometry(rows: list[dict]) -> dict[tuple, list[dict]]:
    """Split measured rows by stream geometry (dataset, mult, partitions,
    per_batch). The acceptance criteria compare models *on the same
    streams*; a multi-geometry CSV (the committed artifact carries both
    benchmark geometries) must never pool a model's rialto rows against
    rf's outdoorStream rows."""
    out: dict[tuple, list[dict]] = {}
    for r in rows:
        key = (
            str(r["dataset"]),
            float(r["mult_data"]),
            int(r["partitions"]),
            int(r["per_batch"]),
        )
        out.setdefault(key, []).append(r)
    return out


class ParitySummary(NamedTuple):
    model: str
    mean: float  # mean over seeds of mean_delay_batches
    std: float  # population std over seeds
    detections: float  # mean detections over seeds
    # Attribution means over seeds (nan when the rows predate the columns —
    # a legacy CSV loaded through summarize still gets the delay fields).
    hits: float
    spurious: float
    recall: float
    first_hit_delay: float  # mean first-hit delay, global-batch units


def _mean_of(rs: list[dict], field: str) -> float:
    vals = [float(r[field]) for r in rs if field in r and r[field] != ""]
    return sum(vals) / len(vals) if vals else float("nan")


def summarize(rows: list[dict]) -> list[ParitySummary]:
    """Per-model mean ± std of the per-seed delays (the PARITY.md table)."""
    by_model: dict[str, list[dict]] = {}
    for r in rows:
        by_model.setdefault(str(r["model"]), []).append(r)
    out = []
    for model, rs in by_model.items():
        d = [float(r["mean_delay_batches"]) for r in rs]
        mu = sum(d) / len(d)
        var = sum((x - mu) ** 2 for x in d) / len(d)
        out.append(
            ParitySummary(
                model,
                mu,
                math.sqrt(var),
                _mean_of(rs, "detections"),
                _mean_of(rs, "hits"),
                _mean_of(rs, "spurious"),
                _mean_of(rs, "recall"),
                _mean_of(rs, "first_hit_delay_batches"),
            )
        )
    return out


def check_criterion(
    rows: list[dict], baseline: str = "rf"
) -> dict[str, float]:
    """Gap of each model vs the baseline family, in global-batch units.

    Returns ``{model: delay(model) − delay(baseline)}``; the acceptance
    criterion is the one-sided ``gap ≤ partitions`` (no more than one
    worker-batch *later* than the RF family; earlier is an improvement).
    Raises if the baseline family is absent.
    """
    summary = {s.model: s for s in summarize(rows)}
    if baseline not in summary:
        raise ValueError(f"baseline model {baseline!r} not in measured rows")
    base = summary[baseline].mean
    return {
        m: s.mean - base for m, s in summary.items() if m != baseline
    }


def check_spurious(
    rows: list[dict], baseline: str = "rf"
) -> dict[str, float]:
    """Spurious-rate inflation of each model vs the baseline family.

    The delay criterion alone is one-sided on lateness: a model that fires
    *more often* can buy a better mean delay with extra detections. This
    closes the loophole on the other axis: per model, the spurious rate is
    ``spurious / (hits + spurious)`` (the fraction of detections that are
    not first hits on a planted boundary), and the returned value is
    ``rate(model) − rate(baseline)``. Acceptance (tests/test_parity.py,
    results/README.md): inflation ≤ 0.15 — a model may spend at most 15
    percentage points more of its detections on non-first fires than the
    reference's RandomForest family on the same streams.
    """
    # summarize() tolerates pre-attribution CSV rows (nan means) for the
    # delay columns, but a rate criterion must not quietly compute over a
    # different row subset than the delay criterion (mixed CSV) or
    # propagate nan into a silent FAIL (all-legacy CSV) — demand the
    # columns on every row.
    for r in rows:
        if r.get("hits", "") == "" or r.get("spurious", "") == "":
            raise ValueError(
                f"row (model={r.get('model')!r}, seed={r.get('seed')!r}) "
                "lacks attribution columns (pre-r03 CSV?); regenerate with "
                "harness.parity"
            )
    summary = {s.model: s for s in summarize(rows)}
    if baseline not in summary:
        raise ValueError(f"baseline model {baseline!r} not in measured rows")

    def rate(s: ParitySummary) -> float:
        total = s.hits + s.spurious
        return s.spurious / total if total else 0.0

    base = rate(summary[baseline])
    return {
        m: rate(s) - base for m, s in summary.items() if m != baseline
    }


def write_csv(rows: list[dict], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)


def report(
    rows: list[dict], progress=print, required: tuple = REQUIRED_MODELS
) -> bool:
    """Per-geometry summary table + both acceptance criteria; returns True
    when every ``required`` model passes both axes in every geometry that
    has the rf baseline. The default gate covers every shipped on-device
    family (``REQUIRED_MODELS``); the sweep additionally measures the
    documented opt-outs (bare ``linear`` at the reference's raw
    sensitivity — its gated form is ``linear@robust``) so the artifact
    still records them honestly without reporting failure for doing so."""
    all_ok = True
    for key, grp in group_by_geometry(rows).items():
        dataset, mult, partitions, _ = key
        progress(f"\n=== {dataset} ×{mult:g}, {partitions} partitions ===")
        progress(
            f"{'Model':<10} {'mean delay':>14} {'first-hit':>10} "
            f"{'detections':>11} {'hits':>6} {'spurious':>8} {'recall':>7}"
        )
        for s in summarize(grp):
            progress(
                f"{s.model:<10} {s.mean:>8.1f} ± {s.std:<4.1f} "
                f"{s.first_hit_delay:>10.1f} {s.detections:>11.0f} "
                f"{s.hits:>6.0f} {s.spurious:>8.0f} {s.recall:>7.3f}"
            )
        if "rf" not in {r["model"] for r in grp}:
            progress("(rf baseline not measured — criterion check skipped)")
            if required:
                # An unevaluable criterion is not a passed criterion: the
                # verdict must not be a vacuous True when the baseline is
                # absent from a geometry.
                all_ok = False
            continue
        spur = check_spurious(grp)
        gaps = check_criterion(grp)
        for model, gap in gaps.items():
            ok_delay = gap <= partitions
            ok_spur = spur[model] <= SPURIOUS_TOLERANCE
            if model in required:
                all_ok = all_ok and ok_delay and ok_spur
            progress(
                f"{model}: delay gap vs rf = {gap:+.1f} global batches "
                f"(criterion ≤ +{partitions}) "
                f"{'OK' if ok_delay else 'FAIL'}; spurious-rate inflation = "
                f"{spur[model]:+.3f} (criterion ≤ +{SPURIOUS_TOLERANCE}) "
                f"{'OK' if ok_spur else 'FAIL'}"
            )
        for m in required:
            if m not in gaps:  # required model never measured here
                all_ok = False
                progress(f"{m}: required but not measured in this geometry")
    return all_ok


def _parse_geometry(spec: str) -> tuple[str, float, int]:
    """'dataset|mult|partitions' (| because dataset specs may contain both
    ':' and ',' — e.g. 'synth:rialto,seed=1')."""
    parts = spec.split("|")
    if len(parts) != 3:
        raise ValueError(
            f"geometry {spec!r} is not 'dataset|mult|partitions'"
        )
    return parts[0], float(parts[1]), int(parts[2])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--geometry",
        action="append",
        default=None,
        metavar="DATASET|MULT|PARTITIONS",
        help="a stream geometry to measure (repeatable); default: both "
        "benchmark geometries (rialto stand-in ×4 and outdoorStream ×64)",
    )
    ap.add_argument("--per-batch", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--models", default=",".join(DEFAULT_MODELS))
    ap.add_argument("--rf-estimators", type=int, default=100)
    ap.add_argument(
        "--out",
        default="results/delay_parity_torch.csv",
        help="per-seed rows (the JAX package's artifact is "
        "results/delay_parity.csv; this default leaves it alone)",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu", "default"],
        help="'cuda' (default): every run on the card; 'cpu' runs in this "
        "process on the CPU, where the rf baseline's scikit-learn is; "
        "'default' is an alias of 'cuda', so the JAX package's command lines "
        "work (its own default is 'cpu', an 8-virtual-device CPU mesh)",
    )
    args = ap.parse_args(argv)
    device = "cpu" if args.device == "cpu" else "cuda"
    geometries = (
        [_parse_geometry(g) for g in args.geometry]
        if args.geometry
        else list(DEFAULT_GEOMETRIES)
    )
    # Fail fast on a missing dataset file: the expensive geometry runs
    # first, and a late FileNotFoundError would discard every measured row
    # (synthetic "synth:..." specs need no file).
    for ds, _, _ in geometries:
        if not ds.startswith("synth:") and not os.path.exists(ds):
            ap.error(f"dataset {ds!r} does not exist")

    rows = []
    for ds, mult, partitions in geometries:
        rows += measure_delay_parity(
            models=args.models.split(","),
            dataset=ds,
            mult_data=mult,
            partitions=partitions,
            per_batch=args.per_batch,
            seeds=range(args.seeds),
            rf_estimators=args.rf_estimators,
            progress=lambda msg, _ds=ds: print(f"[{_ds}] {msg}"),
            device=device,
        )
        # Incremental write: a crash in a later geometry must not discard
        # the completed ones' measurements.
        write_csv(rows, args.out)
    print(f"\nwrote {args.out} ({len(rows)} rows)")
    # Exit status carries the acceptance verdict (CI/cron don't scrape
    # stdout for 'FAIL'). The gate covers the required families *that were
    # swept*: a deliberate --models subset is an informational run and must
    # not exit 1 for omitting families.
    required = tuple(
        m for m in REQUIRED_MODELS if m in args.models.split(",")
    )
    raise SystemExit(0 if report(rows, required=required) else 1)


if __name__ == "__main__":
    main(sys.argv[1:])
