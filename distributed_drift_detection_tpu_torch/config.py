"""Configuration of the PyTorch/CUDA port — a verbatim copy of
``distributed_drift_detection_tpu/config.py``.

The port keeps its own copy instead of importing the JAX package's, so the
two packages never share a module; both accept the same ``RunConfig``
fields, which is what lets the tests hold one against the other. Fields the
port does not run yet raise ``NotImplementedError`` in ``api.run``.

One dataclass replaces the reference's module-level constant block
(``DDM_Process.py:1-35``) and its commented-out argv mode (``DDM_Process.py:15-21``).
Knob names are kept recognisable to a user of the reference:

=====================  =============================================
reference knob          here
=====================  =============================================
INSTANCES               ``partitions`` (stream partitions; data-parallel axis)
PER_BATCH               ``per_batch``
MIN_NUM_DDM_VALS        ``min_num_instances``
WARNING_LEVEL           ``warning_level``
CHANGE_LEVEL            ``out_control_level``
MULT_DATA               ``mult_data``
FILENAME                ``dataset``
URL / MEMORY / CORES    ``backend`` (+ backend-specific options); the Spark
                        cluster knobs have no TPU meaning and are recorded
                        verbatim into the results CSV for table parity —
                        except ``cores``, which additionally drives the
                        ``model='rf'`` sklearn ``n_jobs`` (mirroring the
                        reference's ``RandomForestClassifier(n_jobs=CORES)``,
                        ``DDM_Process.py:102``).
=====================  =============================================

Deliberate deviations (SURVEY.md quirk register):
  * ``NUMBER_OF_FEATURES`` (``DDM_Process.py:33``) is inferred from the data.
  * dead ``REGRESSION_THRESH`` (``DDM_Process.py:31``) is dropped.
  * all randomness is keyed off ``seed`` (the reference's shuffles are unseeded,
    ``DDM_Process.py:49,187,190``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple


class DDMParams(NamedTuple):
    """DDM detector hyper-parameters (Gama et al. 2004).

    The reference constructs ``skmultiflow.drift_detection.DDM`` with the
    far-more-sensitive-than-default values ``3 / 0.5 / 1.5``
    (``DDM_Process.py:27-29,139``); those exact values are required to
    reproduce its detection-delay behaviour, so they are the defaults here.
    """

    min_num_instances: int = 3
    warning_level: float = 0.5
    out_control_level: float = 1.5
    # Band-width noise floor Δ (0 = off, classic DDM — the reference-exact
    # default): the minimum running-error-rate excursion treated as change.
    # DDM's change band is ``level · s_min``; a model with any stretch of
    # error-free elements captures ``p_min = s_min = 0``, after which the
    # band is zero-width and a SINGLE residual error fires a change — the
    # measured r04 'linear' over-firing loop (~15×, PARITY.md), which no
    # level setting can fix (any level × 0 is still 0). With a floor, the
    # change band is ``max(out_control_level·s_min, Δ)`` and the warning
    # band scales as ``(warning_level/out_control_level)·Δ``, preserving
    # the reference's band geometry (implemented as a floored band *std*:
    # ``max(s_min, Δ/out_control_level)``, ops/ddm._band_s). Minima
    # tracking is untouched — Δ=0 reproduces classic DDM bit-for-bit. See
    # DDM_ROBUST below for the shipped preset.
    noise_floor: float = 0.0


# The reference cranks DDM's sensitivity to 3/0.5/1.5 (the DDMParams
# defaults above — required for its detection-delay parity). That choice is
# tuned for near-zero in-concept error: a family with a small *residual*
# error rate (linear's ≈1% softmax residue on rialto-like regimes) arms the
# zero-minima trap (see ``noise_floor``) and over-fires ~15× (r04
# PARITY.md) — and the detector's own published 30/2.0/3.0 levels cannot
# fix it, because any level × a zero-width band is still zero (measured:
# 30/2/3 alone leaves 389 spurious fires on the stand-in). DDM_ROBUST
# keeps the reference's levels and adds the excursion floor. Δ = 0.1 is
# the measured r05 sweep optimum (Δ ∈ {0.075, 0.1, 0.15, 0.2} on the
# stand-in, 2 seeds): recall 1.000, spurious rate 0.13 (vs rf's 0.51),
# mean delay 31 global batches (vs rf's 50) — linear passes both parity
# axes with margin; Δ ≥ 0.15 only trades detection delay for little
# further spurious reduction. Committed evidence:
# results/delay_parity.csv 'linear@robust' rows. Usage:
# ``RunConfig(model='linear', ddm=DDM_ROBUST)``.
DDM_ROBUST = DDMParams(noise_floor=0.1)


class PHParams(NamedTuple):
    """Page–Hinkley hyper-parameters (detector='ph', ops/detectors.py).

    ``delta`` is the magnitude tolerance, ``threshold`` (λ) the detection
    bar, ``alpha`` the forgetting factor on the cumulative statistic
    (1.0 = classic unforgetting CUSUM), ``warning_fraction`` the
    reported-only warning bar as a fraction of λ.

    λ is a *cumulative* excess-error budget: the detector needs roughly λ
    error elements beyond the running mean before firing, so it must be
    small relative to the per-partition concept length (λ=50 on 100-element
    concepts detects late or never — the same sensitivity story as the
    reference cranking DDM's defaults 30/2/3 down to 3/0.5/1.5,
    ``DDM_Process.py:27-29``).

    ``threshold = 0`` (the default) means **auto**: ``api.prepare`` resolves
    λ from the stream's planted-drift geometry via
    :func:`auto_ph_threshold` — the same pattern as ``window = 0`` →
    :func:`auto_window` — so ``RunConfig(detector='ph')`` detects out of the
    box at any benchmark geometry. Pass an explicit λ (e.g. the classic 50)
    to pin it; detector kernels refuse an unresolved 0.
    """

    min_num_instances: int = 30
    delta: float = 0.005
    threshold: float = 0.0  # 0 = auto (config.auto_ph_threshold)
    alpha: float = 1.0
    warning_fraction: float = 0.5


class EDDMParams(NamedTuple):
    """EDDM hyper-parameters (detector='eddm', ops/detectors.py;
    Baena-García et al. 2006 defaults).

    ``paper_exact`` selects the distance semantics for the first error after
    init/reset: ``False`` (default) keeps the framework's documented
    deviation — one uniform ``d = t − last_err_t`` recurrence whose first
    post-reset error contributes a synthetic distance measured from the
    reset; ``True`` is Baena-García 2006 exactly — the first error merely
    arms the distance origin and ``min_num_errors`` counts *distances*.
    The deviation is quality-neutral but not flag-neutral (measured numbers
    in PARITY.md "EDDM deviation"), so paper-comparable runs should set
    ``True``; the default preserves the framework's historical flags."""

    min_num_errors: int = 30
    warning_alpha: float = 0.95
    change_beta: float = 0.9
    paper_exact: bool = False


class HDDMParams(NamedTuple):
    """HDDM-A hyper-parameters (detector='hddm', ops/detectors.py;
    Frías-Blanco et al. 2015 "A-test" defaults).

    Both knobs are *confidences* for Hoeffding bounds — scale-free, so
    unlike Page–Hinkley's λ they need no per-stream auto-resolution: the
    bound tightens with sample count automatically. ``drift_confidence``
    gates detection, ``warning_confidence`` the reported-only warning zone
    (larger = more sensitive)."""

    drift_confidence: float = 0.001
    warning_confidence: float = 0.005


class HDDMWParams(NamedTuple):
    """HDDM-W hyper-parameters (detector='hddm_w', ops/detectors.py;
    Frías-Blanco et al. 2015 "W-test" defaults).

    The W-test is the EWMA companion of the A-test (:class:`HDDMParams`):
    ``lam`` is the exponential forgetting weight of the moving averages
    (larger = faster-forgetting, more reactive to abrupt drift, noisier);
    the confidences gate the McDiarmid-style bounds on *weighted* means the
    same way the A-test's gate its Hoeffding bounds — scale-free, so no
    per-stream auto-resolution is needed here either."""

    lam: float = 0.05
    drift_confidence: float = 0.001
    warning_confidence: float = 0.005


class ADWINParams(NamedTuple):
    """ADWIN hyper-parameters (detector='adwin', ops/adwin.py; Bifet &
    Gavaldà 2007 "ADaptive WINdowing").

    ``delta`` is the detection confidence of the adaptive-window cut test
    (smaller = fewer false alarms, longer delay). ``clock`` is both the
    check cadence *and* the bucket granularity (ops/adwin.py "TPU
    restructuring"): cuts are tested — and can only land — every
    ``clock``-th absorbed element (the classic implementations' default
    check cadence of 32), and a level-k histogram bucket spans
    ``clock·2^k`` elements. ``max_buckets`` (the paper's M) bounds the
    per-level bucket count and ``max_levels`` the depth — capacity is
    ``M·clock·(2^max_levels − 1)`` elements (~168 M at the defaults),
    beyond which the oldest bucket is forgotten (bounded-memory sliding
    window); the capacity must fit int32 (validated), and the absorb
    counter shares that 2³¹ ceiling per reset-free stream — the engines
    reset on every change, and the >2³¹ soak machinery runs chained legs,
    so neither limit binds in practice. ``min_window`` / ``min_side``
    gate the test on minimum evidence (whole window / either side of a
    split). All knobs are scale-free — no per-stream auto-resolution is
    needed."""

    delta: float = 0.002
    clock: int = 32
    max_buckets: int = 5
    max_levels: int = 20
    min_window: int = 10
    min_side: int = 5


class KSWINParams(NamedTuple):
    """KSWIN hyper-parameters (detector='kswin', ops/detectors.py; Raab,
    Heusinger & Schleif 2020 defaults).

    A sliding window of the last ``window_size`` error indicators is split
    into its newest ``stat_size`` elements and the remainder; change fires
    when the two-sample Kolmogorov–Smirnov test rejects at significance
    ``alpha``. On Bernoulli inputs the KS statistic degenerates to the
    proportion gap ``|p̂_recent − p̂_old|`` (the module docstring derives
    this), so the whole test is a rolling-mean comparison against the
    closed-form KS critical value — no empirical CDFs needed. Three
    documented deviations from the reference implementation: the "old"
    sample is the *entire* older window rather than a ``stat_size``-sized
    uniform subsample (the subsample exists to cheapen a host KS test;
    here the full comparison is free and strictly lower-variance); the
    decision uses the asymptotic critical-value form of the test rather
    than the exact p-value; and on detection the window is *emptied* (the
    framework's uniform caller-reset contract — the engines discard
    detector state and retrain) rather than retaining the newest
    ``stat_size`` elements, so re-arming after a change takes a full
    ``window_size`` warm-up instead of ``window_size − stat_size``."""

    alpha: float = 0.005
    window_size: int = 100
    stat_size: int = 30


class STEPDParams(NamedTuple):
    """STEPD hyper-parameters (detector='stepd', ops/detectors.py; Nishida
    & Yamauchi 2007 defaults).

    *Statistical Test of Equal Proportions*: the error rate of the most
    recent ``window_size`` elements against the overall rate since the
    last reset, via the two-proportion z-test with pooled variance and
    continuity correction. Change fires when the test rejects at
    ``alpha_drift`` with the recent rate *higher* (the direction the
    engines' rotate-on-drift loop consumes); ``alpha_warning`` gates the
    reported-only warning zone the same way (the paper's two-level
    scheme — like DDM's, and unlike ADWIN/KSWIN, STEPD has a real warning
    level). Tested once at least ``2·window_size`` elements have been
    absorbed."""

    alpha_drift: float = 0.003
    alpha_warning: float = 0.05
    window_size: int = 30


# Valid RunConfig.detector values (kernels in ops/detectors.py +
# ops/adwin.py). Lives here, not in ops/, so jax-free consumers (the grid
# harness CLI) can validate without initialising a backend.
DETECTOR_NAMES = (
    "ddm", "ph", "eddm", "hddm", "hddm_w", "adwin", "kswin", "stepd",
)

# Valid RunConfig.data_policy values (io/sanitize.py POLICIES — mirrored
# here, like DETECTOR_NAMES, so jax-free consumers (grid/heal/doctor CLIs)
# validate without importing the io package, which pulls in jax).
DATA_POLICIES = ("strict", "quarantine", "repair")

# Valid RunConfig.collect values (parallel/mesh.py collect epilogue):
# 'compact' ships the device-compacted detection table, 'full' the packed
# [5,P,NB-1] flag plane. Flags are bit-identical either way (tested).
COLLECT_MODES = ("compact", "full")


class ServeParams(NamedTuple):
    """Deployment knobs of the online serving daemon (``serve`` subsystem).

    Everything *model/detector/stream-shaped* stays on :class:`RunConfig`
    (the serve loop runs the same engines); this tuple holds only what a
    long-lived service adds on top. jax-free, like the rest of this module,
    so the ``serve``/``loadgen`` CLIs can validate argv without a backend.

    ``num_features``/``num_classes`` are **required** (> 0): a daemon must
    know its row geometry before the first row arrives — chunk shapes are
    static (the no-recompile contract), and the model spec is built from
    them, not inferred from data the way the batch loader does.
    """

    num_features: int = 0  # required: feature count of every ingress row
    num_classes: int = 0  # required: label domain 0..C-1
    host: str = "127.0.0.1"
    # TCP ingress port (0 = OS-assigned, printed in the startup banner);
    # None = no socket at all — the in-process embedding used by tests and
    # bench --serve drives the admission controller directly.
    port: "int | None" = 0
    # Microbatch geometry: one flushed chunk is [partitions, chunk_batches,
    # per_batch] rows (partitions/per_batch from the RunConfig).
    chunk_batches: int = 4
    # Max-linger deadline: a partial microbatch older than this is flushed
    # short (padded through the validity plane — static shapes, no
    # recompile) rather than waiting for the grid to fill.
    linger_s: float = 0.25
    # Serving-loop poll granularity (batcher waits, stop checks).
    poll_s: float = 0.05
    # Wire-protocol-v2 decoder bound: a binary frame header declaring
    # more rows than this is malformed, not merely large — the ingress
    # refuses it (ERR + connection close) BEFORE allocating its payload
    # buffer, so a corrupt or hostile header cannot OOM the daemon.
    # 0 = the codec's own default (serve.wire.MAX_FRAME_ROWS — the one
    # copy of the constant; this jax-free module must not import it).
    # The v1 text protocol has no equivalent knob (lines are admitted
    # per recv block).
    max_frame_rows: int = 0
    # Checkpoint path ('' = stateless serving): the detector carry +
    # stream-position meta, written atomically after every
    # ``checkpoint_every``-th published microbatch and at drain — the
    # kill-and-resume contract.
    checkpoint: str = ""
    checkpoint_every: int = 1
    # Fleet identity of this daemon (serve --name): stamped into every
    # verdict record as "daemon" so a router-fronted fleet's sidecars
    # stay attributable per backend — the join key loadgen --router uses
    # against the router's placement journal. '' (default) = unstamped
    # (solo daemons need no identity).
    name: str = ""
    # Global tenant identity per slot (serve --tenant-ids): a fleet
    # daemon's T slots serve T *global* tenants — slot s runs global
    # tenant ``tenant_ids[s]``'s solo identity (stream seed + stripe
    # shuffle seed = config.tenant_configs' ``seed + id`` convention), so
    # its flags stay bit-identical to THAT tenant's solo run wherever
    # the router places it. ``-1`` marks a vacant spare slot (masked,
    # receives no traffic) the router can LOADTENANT a migrating or
    # orphaned tenant into — slot counts are compiled into the kernel
    # (static shapes), so failover capacity is provisioned, not grown.
    # Empty (default) = the identity mapping 0..T-1 (the PR-9 solo-host
    # posture; nothing changes for existing daemons).
    tenant_ids: tuple = ()
    # Per-tenant solo-shaped checkpoints (serve --tenant-checkpoints):
    # next to every plane checkpoint, also write one
    # ``<checkpoint>.t<slot>`` per tenant slot via
    # ChunkedDetector.save_tenant — the migration currency of the tenant
    # router: when THIS daemon dies, the router re-places each orphaned
    # tenant by LOADTENANT-ing its solo checkpoint into a surviving
    # daemon and replaying the delta. Off by default (T extra files per
    # checkpoint is a fleet posture, not a solo one).
    tenant_checkpoints: bool = False
    # Idle liveness: emit a heartbeat event at least this often even with
    # no traffic, so `watch --stall-after` can tell "idle" from "dead".
    heartbeat_s: float = 10.0
    # --- ops plane (telemetry.ops / .slo / .trace) ---
    # HTTP ops port (None = no ops server; 0 = OS-assigned, see banner):
    # /metrics (live Prometheus text), /healthz (200 healthy / 503 while
    # an SLO alert fires or the ingress poisoned the batcher), /statusz
    # (JSON snapshot). Binds to `host`, like the ingress.
    ops_port: "int | None" = None
    # Declarative SLO rules, `kind=threshold` each (telemetry.slo
    # RULE_KINDS: p99_ms, verdict_age_s, quarantine_pct, stall_s) or a
    # multi-window `burn_rate=SERIES:OBJECTIVE:FAST/SLOW:FACTOR` pair
    # over any snapshot series; ("none",) disables alerting. The default
    # ships a stall alarm so an out-of-the-box daemon can tell "wedged"
    # from "idle".
    slo: tuple = ("stall_s=60",)
    # Per-tenant hotness series (serve --tenant-series): export
    # serve_tenant_rows_total{tenant=<global id>} on /metrics so the
    # history plane can rank tenant activity (`history top-tenants`).
    # Off by default — per-tenant label values are a cardinality cost
    # every scrape pays forever, so hotness is an opt-in fleet posture.
    tenant_series: bool = False
    # Cardinality guard for the above: a daemon with more tenant slots
    # than this refuses --tenant-series at startup instead of silently
    # flooding every scrape (raise it explicitly if you mean it).
    tenant_series_max: int = 512
    # Evaluator cadence (its own daemon thread — the serve loop being
    # wedged is exactly what stall_s must catch).
    slo_interval_s: float = 1.0
    # Crash flight recorder: ring capacity in events. On an unhandled
    # exception the last N run-log events dump to
    # `<run-log>.flightrec.jsonl`; a clean drain leaves no dump. 0 = off.
    flightrec_events: int = 256
    # Serve-pipeline observatory (telemetry.pipeline): per-stage busy
    # accounting (serve_stage_busy_seconds_total), the /statusz
    # `pipeline` section, and per-chunk stage spans. Stamps are cheap
    # monotonic reads folded in outside the hot dispatch; False turns
    # the accounting off entirely (the CLI's --no-pipeline-metrics) —
    # verdict sidecars are bit-identical either way.
    pipeline_metrics: bool = True
    # --- trace plane (telemetry.tracing / .forensics) ---
    # Daemon-side head-sampling rate for rows the client did NOT stamp
    # with a TRACE wire line: each sampled row gets a fresh root trace
    # and the full serving span chain in the run log. 0 (default) = off:
    # zero hot-path tracing work — client-stamped rows are still always
    # honored (the client already paid the head decision).
    trace_sample: float = 0.0
    # Drift forensics: on a drift verdict, extract an evidence bundle
    # (error-rate trajectory, warn/drift thresholds, window stats,
    # context rows, sampled trace ids) host-side into
    # `<run-log>.forensics/` and emit a `drift_forensics` event.
    # Requires a telemetry dir (bundles anchor to the run log's stem);
    # False disables capture entirely.
    forensics: bool = True
    # --- adaptation plane (adapt/ subsystem) ---
    # Per-tenant drift-reaction policy specs (adapt.policy grammar; the
    # CLI's repeatable --on-drift). Each spec is `POLICY[,k=v...]`
    # plane-wide or `T=POLICY[,k=v...]` per tenant, POLICY one of
    # alert_only|retrain|shadow. Empty (the default) = alert_only for
    # every tenant: verdicts only publish — today's behaviour,
    # byte-identical (no adaptation code runs at all).
    on_drift: tuple = ()
    # --- incident autopsy plane (telemetry.incident) ---
    # Alert-triggered cross-plane evidence capture: when an SLO alert
    # fires (or the daemon crashes), snapshot the flight ring, pipeline
    # attribution, /statusz, verdict/quarantine tails, and (with a
    # history store) the recent fleet window into one numbered
    # `<run-log>.incidents/incident-NNNN/` bundle — captured on the SLO
    # evaluator thread, never the serve loop; verdict sidecars are
    # bit-identical either way. Requires a telemetry dir (bundles
    # anchor to the run-log stem); False (--no-incidents) disables.
    incidents: bool = True
    # Bundle cap per run: alert flapping must not fill the disk —
    # captures beyond this are counted (`skipped`), not written.
    incident_max: int = 32
    # History-store directory (the collector's --store): when set, each
    # bundle also extracts the recent time-series window + top-tenant
    # ranking. '' = no history extract (a solo daemon has no store).
    incident_store: str = ""
    # Seconds of history extracted into each bundle.
    incident_window_s: float = 120.0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Full configuration of one drift-detection run."""

    # --- data (reference C2, DDM_Process.py:38-55) ---
    dataset: str = "outdoorStream.csv"
    mult_data: float = 1.0
    standardize: bool = True
    # Ingest contract policy for CSV datasets (io/sanitize.py): 'strict'
    # (default) raises a structured StreamContractError naming
    # file/row/column on any violation — non-numeric cell, non-finite
    # value, ragged row, bad label domain — instead of the reference's
    # crash-or-poison behaviour; 'quarantine' drops violating rows into a
    # quarantine.jsonl sidecar and carries them as masked positions
    # (inside jit they read as padding — static shapes, and the detector
    # statistics are exactly the clean stream's with those rows masked);
    # 'repair' imputes finite column means for NaN cells and clamps
    # non-integral labels, quarantining what it cannot fix. Clean streams
    # are bit-identical under every policy. Synthetic datasets ('synth:')
    # generate by construction and skip the scan.
    data_policy: str = "strict"
    # Quarantine sidecar path ('' = auto: telemetered runs write a
    # per-run `<run-log>.quarantine.jsonl` next to the run log so
    # repeated trials stay attributable; without telemetry it is
    # ./quarantine.jsonl — resolve_quarantine_path). Appended to, one
    # JSON line per quarantined row; written only when a row is actually
    # quarantined (quarantine AND repair policies — repair drops what it
    # cannot fix).
    quarantine_path: str = ""

    # --- loop (reference C7, DDM_Process.py:162-213) ---
    per_batch: int = 100
    shuffle_batches: bool = True  # seeded analog of .sample(frac=1) at :187,190
    # 'majority' | 'centroid' | 'gnb' | 'linear' | 'mlp' | 'forest' | 'rf'
    # ('forest' is the on-device extremely-randomized oblique forest; 'rf'
    # is the host-callback reference-parity RandomForest, models/rf.py;
    # like 'mlp' their fits consume a PRNG key, so their flags are
    # seed-equivalent but not bit-equal across different `window` values). 'centroid' is the
    # documented flagship (PARITY.md: closed-form fit, rf-grade delay) and
    # what bench.py measures; 'linear' over-fires ~15× on rialto-like
    # regimes, so it is deliberately not the default.
    model: str = "centroid"

    # --- detector (reference C6) ---
    # 'ddm' (the reference's statistic) | 'ph' (Page–Hinkley) | 'eddm' |
    # 'hddm' (HDDM-A, Hoeffding-bound) | 'hddm_w' (HDDM-W, its EWMA
    # companion) | 'adwin' (adaptive windowing; the zoo's only
    # scan-based kernel — see ops/adwin.py) | 'kswin' (sliding-window
    # KS test) | 'stepd' (two-proportion test, recent vs overall) — the
    # detector zoo, ops/detectors.py. Non-DDM detectors are a framework
    # extension: the reference only ships DDM, so cross-reference parity
    # claims (delay tables, oracle goldens) hold for detector='ddm'.
    detector: str = "ddm"
    ddm: DDMParams = DDMParams()
    ph: PHParams = PHParams()
    eddm: EDDMParams = EDDMParams()
    hddm: HDDMParams = HDDMParams()
    hddm_w: HDDMWParams = HDDMWParams()
    adwin: ADWINParams = ADWINParams()
    kswin: KSWINParams = KSWINParams()
    stepd: STEPDParams = STEPDParams()
    # Fallback retrain: force rotate+reset+retrain (without recording a DDM
    # change) when a batch's error rate exceeds this threshold. Cures DDM's
    # structural blindspot — a detector reset immediately before a ~100%-error
    # regime pins p_min at 1.0 and never fires again. The reference ships the
    # same idea as the *dead* constant REGRESSION_THRESH = 0.3
    # (DDM_Process.py:31, never referenced).
    #
    # Default RETRAIN_AUTO (VERDICT r4 #1 saturation guardrail): resolved by
    # :func:`resolve_retrain_threshold` to AUTO_RETRAIN_THRESHOLD for the
    # model families that *need* it (``GUARDED_MODELS`` — the memorizer
    # families whose measured failure mode is exactly the blindspot above)
    # and to None (reference-exact behaviour) for every other family. Pass
    # None to disable explicitly, or a float to pin.
    retrain_error_threshold: float | None = -1.0  # RETRAIN_AUTO sentinel

    # --- distribution (reference C8, DDM_Process.py:216-226) ---
    partitions: int = 8  # reference INSTANCES: row-striped stream partitions
    mesh_devices: int = 0  # 0 = all visible devices
    # Tenant-axis rows of a 2-D (tenant, partition) device mesh (ROADMAP
    # item 1, fleet-scale serving): > 1 reshapes the mesh to
    # [mesh_tenant_devices, rest] named (tenants, partitions), so the
    # stacked [T·P, ...] tenant plane shards whole tenants across
    # tenant-axis rows while each tenant's partitions spread along the
    # partition axis (parallel.mesh.make_mesh(tenant_devices=...),
    # per-leaf placement via the plane_rules regex→PartitionSpec tree).
    # Per-tenant flags are bit-identical at EVERY mesh shape — the PR-9
    # parity contract quantified over shardings (tested). Constraints,
    # checked loudly: the tenant count and the device count must both
    # split over the tenant axis. 0 (default) keeps the historical 1-D
    # partition mesh everywhere.
    mesh_tenant_devices: int = 0
    # Multi-tenant stream plane (api.prepare_multi / api.run_multi): run N
    # INDEPENDENT streams — each with its own detector + classifier state —
    # through ONE compiled kernel by stacking their [P, NB, B] grids on the
    # leading axis into [T·P, NB_max, B]. Tenant t's stream is the solo
    # config with seed = seed + t and any '{tenant}' placeholder in
    # `dataset` substituted (config.tenant_configs); ragged tenant lengths
    # are absorbed by the validity plane (masked rows == padding inside
    # jit — static shapes, zero recompiles), and per-tenant flags are
    # bit-identical to N solo runs. 1 (default) = the classic single-stream
    # path, byte-for-byte unchanged. `api.run` rejects tenants > 1 — the
    # multi-tenant result is per-tenant structured (use run_multi).
    tenants: int = 1

    # --- execution strategy ---
    # Speculative window width (engine.window): microbatches processed per
    # sequential step between drift checks. 1 = faithful batch-per-step scan;
    # >1 commits up to the first in-window change and replays the rest —
    # identical flags for deterministic-fit models (majority/centroid/gnb/linear),
    # ~window× fewer sequential steps. 0 (the default) = auto: co-resolve the
    # width with ``window_rotations`` from the stream's planted drift spacing
    # (config.auto_window; at the headline benchmark geometry the resolution
    # is the measured r03 W×R sweep optimum, 128×4 — see bench.py's sweep
    # table). Pass an explicit width to pin it. Caveat: the key-consuming
    # 'mlp' fit draws its init keys per *window*, not per batch, so its flags
    # are seed-equivalent but not bit-equal across different window values —
    # pin window=1 for run-to-run bit-reproducibility of 'mlp' experiments.
    window: int = 0
    # Speculation depth of the window engine (engine.window): how many
    # rotate-and-replay passes one sequential step may commit. 1 = classic
    # single-rotation speculation; R > 1 replays up to R−1 times inside the
    # same step — after an in-window change the model refits and the tail
    # re-runs immediately — cutting sequential steps from ≈ NB/W + drifts
    # toward ≈ NB/W + drifts/R. Flags are bit-identical to the sequential
    # engine for deterministic-fit models at any depth (tested); like
    # `window`, the depth is part of 'mlp'/'rf''s seed story. Each level
    # costs one extra predict + detector pass of device work per step —
    # pure win in the dispatch-latency-bound regimes the window engine
    # exists for, wasted FLOPs where drift is absent (keep 1 there).
    # 0 (the default) = auto: resolve the depth from stream geometry (the
    # concepts one window spans; config.auto_rotations — co-tuned with
    # auto_window so the defaults land on the measured W×R optimum).
    window_rotations: int = 0
    # Collect-phase transport (parallel/mesh.py): 'compact' (default) fuses
    # a segment-compaction epilogue into the detect program — the device
    # returns a small dense detection table (partition, batch, flag values;
    # fixed capacity, sentinel fill, embedded event counter) and the host
    # reconstructs the full flag table from it, so the latency-bound d2h
    # collect ships O(detections) bytes instead of the whole packed
    # [5, P, NB-1] plane. 'full' keeps the round-5 full-plane path — the
    # escape hatch for parity A/Bs; ``validate=True`` forces it too (the
    # structural audit wants the plane the device actually produced, not a
    # reconstruction). Flags are bit-identical across modes (tested); a
    # table overflow (more flagged slots than capacity) falls back to the
    # full plane loudly (RuntimeWarning), never truncates.
    collect: str = "compact"
    # Compacted-table capacity in entries (0 = auto: sized from the stripe
    # geometry, parallel.mesh.auto_compact_capacity — ~P·NB/8 slots, the
    # point where the table is still ~6× smaller than the plane while
    # overflow needs >12.5% of all slots flagged). Explicit values exist
    # for overflow tests and for streams known to flag densely.
    collect_capacity: int = 0
    # Host-ingest parse fan-out of the streaming CSV path
    # (io.feeder.csv_chunks ``workers=``; the `chunked` CLI's
    # --ingest-workers and bench.py's flag of the same name). 0 = auto:
    # one parse worker per core, capped at 4
    # (io.feeder.resolve_ingest_workers). Blocks are parsed concurrently
    # but reassembled in file order, so ANY worker count yields
    # bit-identical chunks, flags and quarantine sidecars (pinned by test
    # + the ingest-smoke CI job) — an execution knob, not experiment
    # identity, so it stays out of the telemetry config digest like
    # collect/compile_cache_dir.
    ingest_workers: int = 0
    # Persistent XLA compilation cache directory ('' = off). When set,
    # compiled executables are cached across *processes* (jax
    # jax_compilation_cache_dir), so repeated sweep cells and restarted
    # soak legs skip compilation entirely; api.prepare additionally
    # AOT-compiles the runner against the stripe geometry
    # (jit.lower().compile()) so even a cold process pays the compile in
    # the prepare phase, never inside the Final Time span. CLI:
    # --compile-cache-dir; bench.py defaults to its own .jax_cache.
    compile_cache_dir: str = ""
    # (Two rejected-by-measurement alternatives are documented in PARITY.md:
    # a `ddm_kernel='pallas'` fused kernel — ~78× slower than the XLA
    # lowering, removed in round 2 ("Pallas post-mortem") — and a
    # `stream_on_device` in-jit stream synthesis — TPU large-array sorts
    # made it ~6× slower end-to-end than the packed host stripe
    # ("Device-synthesis post-mortem").)

    # --- model hyper-parameters (TPU-native replacements for RandomForest) ---
    fit_steps: int = 32
    learning_rate: float = 0.5
    mlp_hidden: tuple[int, ...] = (128, 64)
    mlp_learning_rate: float = 0.05
    # model='rf' (host-callback parity path, models/rf.py): forest size; the
    # reference uses sklearn's default 100 trees (DDM_Process.py:102).
    rf_estimators: int = 100
    # model='forest' (on-device extremely-randomized oblique forest,
    # models/classifiers.py make_forest): ensemble size and complete-tree
    # depth (2^depth leaves per tree).
    forest_trees: int = 32
    forest_depth: int = 3

    # --- execution ---
    backend: str = "jax"  # 'jax' ('spark' is formally retired — api.run)
    seed: int = 0
    # Host-side structural audit of the collected flag table after every run
    # (utils.validate.validate_flag_rows); raises on corruption. Cheap (runs
    # on the tiny flag table), off by default for exact reference parity of
    # the timed span.
    validate: bool = False
    # When set, wrap the detection phase in a jax.profiler trace written to
    # this directory (aux subsystem: tracing/profiling, SURVEY.md §5) —
    # inspect with TensorBoard or Perfetto.
    trace_dir: str = ""
    # When set, wrap the ENTIRE Final Time span (upload + detect + collect)
    # in a jax.profiler trace written to this directory, so the
    # TensorBoard/Perfetto-readable capture lands next to the run's
    # telemetry artifacts (CLI: --profile-dir). Profiling inevitably
    # perturbs what it measures — the capture rides *inside* the timed
    # span by design (that is the span being profiled); treat the run's
    # Final Time as diagnostic, not a headline. Mutually exclusive with
    # trace_dir (jax rejects nested profiler sessions; api.run fails
    # loudly before starting work).
    profile_dir: str = ""
    # When set, api.run persists a structured JSONL event log for the run
    # into this directory (one file per run; schema docs/OBSERVABILITY.md)
    # plus JSON/Prometheus metric exports, summarizable offline with
    # `python -m distributed_drift_detection_tpu report <run.jsonl>`.
    # None (default) = off: no telemetry code executes, and every event is
    # emitted outside the reference-parity Final Time span either way.
    telemetry_dir: str | None = None

    # --- bookkeeping (recorded verbatim into the results CSV, C11 parity) ---
    app_name: str = ""
    time_string: str = "Placeholder"
    url: str = "jax://local"
    memory: str = "-"
    cores: int = 0
    results_csv: str = "ddm_cluster_runs.csv"  # fixed: ref wrote sparse_* (:273)

    def resolved_app_name(self) -> str:
        # Reference: APP_NAME = "%s-%s" % (FILENAME, TIME_STRING)  (:23)
        return self.app_name or f"{self.dataset}-{self.time_string}"


def replace(cfg: RunConfig, **kw: Any) -> RunConfig:
    return dataclasses.replace(cfg, **kw)


def resolve_quarantine_path(cfg: RunConfig) -> str:
    """The quarantine sidecar path a config implies: an explicit
    ``quarantine_path`` wins; otherwise it lands next to the run's other
    artifacts (``<telemetry_dir>/quarantine.jsonl``) when telemetry is
    on, or in the working directory when not. jax-free (CLI-safe)."""
    if cfg.quarantine_path:
        return cfg.quarantine_path
    if cfg.telemetry_dir:
        import os

        return os.path.join(cfg.telemetry_dir, "quarantine.jsonl")
    return "quarantine.jsonl"


def telemetry_config_payload(cfg: RunConfig) -> dict:
    """The config dict ``api.run`` emits in ``run_started`` and digests
    into the registry (``telemetry.registry.config_digest``).

    Single source of truth shared with ``resilience.heal``: the heal
    planner recomputes every expected trial's digest from its spec, and
    a drifted field set would make completed trials read as missing (or
    worse, missing ones as completed). ``window``/``window_rotations``
    are the *requested* values (0 = auto, resolved later by prepare);
    bookkeeping fields (time_string, telemetry_dir, ...) stay out — two
    runs of the same experiment must share a digest.

    Values are type-normalized (``mult_data`` → float, counts → int):
    JSON renders ``1`` and ``1.0`` differently, so without this a sweep
    launched with integer mults and a heal planner normalizing to float
    would digest the *same cell* two ways and re-run completed work.
    """
    payload = {
        "dataset": str(cfg.dataset),
        "model": cfg.model,
        "detector": cfg.detector,
        "partitions": int(cfg.partitions),
        "per_batch": int(cfg.per_batch),
        "mult_data": float(cfg.mult_data),
        "seed": int(cfg.seed),
        "backend": cfg.backend,
        "window": int(cfg.window),
        "window_rotations": int(cfg.window_rotations),
    }
    # A non-default data policy is experiment identity: on a dirty stream
    # it changes which rows reach the detector, hence the flags. The
    # default stays OUT of the payload — same rule as the grid's
    # _config_key `-dp` segment — so registries recorded before the
    # policy existed keep matching their cells (heal must not re-run a
    # whole completed sweep over a digest-schema change).
    if cfg.data_policy != "strict":
        payload["data_policy"] = str(cfg.data_policy)
    # Same default-stays-out rule for the tenant count: a T-tenant run is a
    # different experiment from a solo run, but pre-tenancy registries must
    # keep matching their solo cells.
    if cfg.tenants != 1:
        payload["tenants"] = int(cfg.tenants)
    return payload


# The payload fields config_from_payload accepts, with their normalizing
# types — exactly the fields telemetry_config_payload can emit. One table
# so the two directions cannot drift silently.
_PAYLOAD_FIELDS: "dict[str, type]" = {
    "dataset": str,
    "model": str,
    "detector": str,
    "partitions": int,
    "per_batch": int,
    "mult_data": float,
    "seed": int,
    "backend": str,
    "window": int,
    "window_rotations": int,
    "data_policy": str,
    "tenants": int,
}


def config_from_payload(payload: dict, **extras) -> RunConfig:
    """The inverse of :func:`telemetry_config_payload`: rebuild a runnable
    :class:`RunConfig` from a digest payload plus the bookkeeping fields
    the digest deliberately excludes (``results_csv``, ``time_string``,
    ``telemetry_dir``, ...).

    The ``sched/`` worker's cell-rebuild contract: a scheduler ships each
    cell as its payload, the worker rebuilds and re-digests, and the two
    must match byte-for-byte — so an *unknown* payload field fails loudly
    here (schema drift between a newer scheduler and an older worker must
    refuse to run the wrong experiment, the same posture as heal's
    unknown-spec-key check). jax-free, like the rest of this module."""
    unknown = set(payload) - set(_PAYLOAD_FIELDS)
    if unknown:
        raise ValueError(
            f"unknown config payload field(s) {sorted(unknown)}; known: "
            f"{sorted(_PAYLOAD_FIELDS)}"
        )
    kw = {k: _PAYLOAD_FIELDS[k](v) for k, v in payload.items()}
    kw.update(extras)
    return RunConfig(**kw)


def tenant_dataset(dataset: str, tenant: int) -> str:
    """Tenant ``t``'s dataset spec: any ``{tenant}`` placeholder in the
    configured dataset string is substituted with the tenant index, so one
    config can fan out over per-tenant sources (e.g.
    ``synth:rialto,seed={tenant},rows_per_class=4{tenant}`` gives every
    tenant its own seed AND a ragged length). Without a placeholder every
    tenant reads the same source (seeds still differ — see
    :func:`tenant_configs`)."""
    return dataset.replace("{tenant}", str(tenant))


def tenant_configs(cfg: RunConfig) -> "list[RunConfig]":
    """Expand a ``tenants = T`` config into the T solo configs it means.

    Tenant ``t`` is the single-stream run with ``seed = cfg.seed + t``
    (its own stream synthesis, PRNG keys and stripe-time shuffle) and
    ``{tenant}``-substituted dataset — the exact runs
    ``api.run_multi``'s per-tenant flags are bit-identical to. jax-free,
    like the rest of this module, so CLIs can expand without a backend.
    """
    if cfg.tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {cfg.tenants}")
    return [
        replace(
            cfg,
            tenants=1,
            seed=cfg.seed + t,
            dataset=tenant_dataset(cfg.dataset, t),
        )
        for t in range(cfg.tenants)
    ]


# Version of the auto W×R resolution policy (auto_window / auto_rotations).
# Bump whenever the resolution *algorithm* changes (v2 = the r04 co-resolved
# depth-4 policy): grid trial keys embed it for auto-mode configs
# (harness.grid._config_key), so trials recorded under an older policy are
# retired on re-run instead of silently resumed onto stale-policy timings —
# '-w0r0' alone names the sentinel, not what it resolves to.
AUTO_POLICY_VERSION = 2


def auto_window(cfg: RunConfig, dist_between_changes: int) -> int:
    """Resolve ``window == 0`` from stream geometry (W of the W×R policy).

    With the multi-rotation engine the sequential-step count is
    ≈ NB/W + drifts/R, and the depth auto-resolution (:func:`auto_rotations`)
    sizes R to the boundaries one window spans — so W gains past the
    per-partition drift spacing ``bpc`` (in batches) up to roughly
    ``R*·bpc``, where each step commits ~R* concepts. The r03 on-hardware
    W×R sweep (table in ``bench.py``) measured the sweet spot at depth
    R* = 4: at the headline geometry (bpc = 32) W=128 R=4 beat both the
    single-rotation optimum (W=64 R=1: 0.165 s → 0.156 s) and every wider /
    deeper cell (W=192 R=4: 0.191 s — per-iteration slice cost; R=8:
    0.199 s — per-level replay cost). Pick the power of two nearest
    ``R*·bpc`` (R* from the pinned depth when the user set one), clamped to
    [4, 128] (tiny windows forfeit the batching win; the cap is where
    measured slice cost overtakes saved iterations). A pinned depth of 1
    reduces to the round-2 policy: W ≈ bpc, one concept per window.
    Streams without planted geometry get 16 (speculation budget without a
    spacing to size against).
    """
    if cfg.window:
        return cfg.window
    bpc = dist_between_changes / max(cfg.partitions * cfg.per_batch, 1)
    if bpc <= 0:
        return 16
    import math

    depth = 4 if cfg.window_rotations == 0 else max(cfg.window_rotations, 1)
    target = max(bpc * depth, 1.0)
    w = 1 << round(math.log2(target))
    return int(min(128, max(4, w)))


def auto_rotations(cfg: RunConfig, dist_between_changes: int) -> int:
    """Resolve ``window_rotations == 0`` (auto) from stream geometry.

    A window of ``W`` batches covers ``W · per_batch`` elements of one
    partition's stream; with planted concepts of ``dist_between_changes /
    partitions`` elements per partition it spans ≈ ``per_window/cpp``
    boundaries, each costing one replay level. Depth =
    round(boundaries-per-window) commits a typical window's boundaries in
    one step (the r03 sweep measured this exact point — R=4 at 4
    boundaries/window — as the optimum, with the +1 safety level R=5
    ~2% slower), clamped to [1, 8] (beyond ~8 the per-level
    predict/detector cost rivals the saved iterations at typical shapes).
    Windows much smaller than a concept round to depth 1 — paying an
    every-step replay level for a rare boundary-straddling window is a
    loss. Resolution needs the *resolved* window — call after
    :func:`auto_window`; at auto W the pair lands on the measured 128×4 at
    headline geometry (pinned by tests). Streams without planted geometry
    keep depth 1 (speculating on absent drift is waste).
    """
    if cfg.window_rotations:
        return cfg.window_rotations
    if dist_between_changes <= 0 or cfg.window <= 1:
        return 1
    concept_pp = dist_between_changes / max(cfg.partitions, 1)
    per_window = cfg.window * cfg.per_batch
    return int(min(8, max(1, round(per_window / concept_pp))))


def auto_ph_threshold(cfg: RunConfig, dist_between_changes: int) -> float:
    """Resolve ``PHParams.threshold == 0`` (auto) from stream geometry.

    λ is Page–Hinkley's cumulative excess-error budget in *elements*: after
    a drift the statistic grows by ≈ (1 − x̄ − δ) per element, so detection
    delay is ≈ λ elements while noise immunity grows with λ. Scale it to the
    per-partition concept length (``dist_between_changes / partitions`` —
    each partition sees a 1/P stripe of every planted concept): λ =
    ``concept_pp / 16``, clamped to [4, 32]. The floor keeps the statistic
    above single-element noise at tiny test geometries; the cap bounds
    detection delay to well under one worker-batch at benchmark geometries
    (measured: λ ∈ [8, 32] detects every planted outdoorStream boundary,
    delay-minimal around λ ≈ 16, while the classic λ = 50 on a 128-element
    concept eats half the concept in delay). Streams with no planted-drift
    geometry (``dist_between_changes <= 0``) fall back to the classic 50.
    """
    if cfg.ph.threshold:
        return cfg.ph.threshold
    if dist_between_changes <= 0:
        return 50.0
    return auto_ph_threshold_rows(
        dist_between_changes / max(cfg.partitions, 1)
    )


def auto_ph_threshold_rows(concept_pp: float) -> float:
    """The λ auto-resolution formula on a *per-partition* concept length in
    rows — the config-free core of :func:`auto_ph_threshold`, shared with
    engines that know their drift geometry directly (``engine.soak``'s
    ``drift_every`` is exactly this quantity)."""
    return float(min(32.0, max(4.0, concept_pp / 16.0)))


# retrain_error_threshold auto-resolution (VERDICT r4 #1) ------------------
#
# RETRAIN_AUTO is the RunConfig default: a negative threshold is meaningless
# as an active setting (err_rate > -1 would force a retrain every batch,
# which 0.0 already expresses more honestly), so it is safe as a sentinel.
RETRAIN_AUTO = -1.0

# The resolved guard value — the reference's own (dead) REGRESSION_THRESH
# idea, DDM_Process.py:31: a batch error rate above 0.3 forces
# rotate+reset+retrain without recording a change.
AUTO_RETRAIN_THRESHOLD = 0.3

# Model families that ship with the guard ON by default: the *memorizer*
# families, whose fits carry ≈ zero accuracy across a concept boundary, so
# one detector reset at a saturated-error position pins DDM's minima at the
# ceiling and silences it forever (the measured r04 failure: gnb and forest
# at recall 0.000 on the rialto stand-in — PARITY.md "domain limit"
# sections; the guard is the measured mitigation). ``majority`` is equally a
# memorizer but stays UNGUARDED by design: it is the bit-exact golden family
# pinned against the NumPy oracle's reference semantics (tests/oracle.py),
# and the guard is not part of those semantics — guard it explicitly via
# ``retrain_error_threshold=0.3`` when using it outside golden tests.
# Mirrored by the per-model ``Model.saturation_guard`` flag
# (models/base.py); ``tests/test_models.py`` pins the two in sync.
GUARDED_MODELS = frozenset({"gnb", "forest"})


def resolve_retrain_threshold(cfg: RunConfig) -> float | None:
    """Resolve ``retrain_error_threshold`` (RETRAIN_AUTO → per-family).

    None and explicit non-negative floats pass through; any negative value
    is the auto sentinel: ``AUTO_RETRAIN_THRESHOLD`` for ``GUARDED_MODELS``,
    None (reference-exact) otherwise. Shared by ``api.prepare`` and the
    grid harness's trial keys (the key must embed what actually ran).
    """
    thr = cfg.retrain_error_threshold
    if thr is None or thr >= 0.0:
        return thr
    return AUTO_RETRAIN_THRESHOLD if cfg.model in GUARDED_MODELS else None


def parse_model_spec(spec: str) -> tuple[str, dict]:
    """Parse a ``family[@variant]`` model spec → (family, RunConfig kwargs).

    The one grammar shared by the parity harness's sweep specs and the
    zoo examples: ``@robust`` selects the shipped ``DDM_ROBUST`` detector
    preset; unknown variants fail loudly here rather than leaking a bogus
    family name downstream.
    """
    family, _, variant = spec.partition("@")
    if variant == "robust":
        return family, {"ddm": DDM_ROBUST}
    if variant:
        raise ValueError(f"unknown model variant {spec!r}; known: @robust")
    return family, {}


def host_shuffle_seed(cfg: RunConfig) -> int | None:
    """The stripe-time shuffle seed a config implies (None = no shuffle).

    Single source of truth shared by ``api.prepare`` and any chunked/soak
    pipeline that wants bit-identical results to the one-shot path — pass
    this as ``shuffle_seed`` to the feeder and run the engine with
    ``shuffle=False``.
    """
    return cfg.seed + 0x5EED if cfg.shuffle_batches else None
