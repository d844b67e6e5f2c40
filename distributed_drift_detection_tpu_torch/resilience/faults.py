"""Deterministic, seeded fault injection (the port's own copy of the JAX
package's ``resilience/faults.py``).

The reference's crash story is untestable by construction: a "cluster
crash" (README.md:13) happens to you, and the recovery dance
(``missing_exps.sh``) is rehearsed only when it does. Here crashes are a
*first-class test input*: known **sites** in the production code call
:func:`fire`, which is a no-op unless that site was explicitly **armed**
— so the supervised-retry, checkpoint-resume and sweep-heal paths are
exercised by tests and a CI smoke job against real injected failures, not
mocks.

Sites (each named where the production code calls :func:`fire`):

=====================  ====================================================
``api.run``            start of a run, inside the registry bracket — a
                       whole-run crash that leaves a ``failed`` record
``grid.cell``          before each sweep trial (``harness.grid.run_grid``);
                       re-fired on supervised retries of the cell
``chunked.feed``       per chunk fed to ``engine.chunked.ChunkedDetector``
                       ("raise at batch K", chunk granularity)
``soak.leg``           before each chained-soak leg executes
                       (``engine.soak.run_soak_chained``)
``checkpoint.save``    between the checkpoint temp-file write and its
                       atomic rename (``utils.checkpoint.save_checkpoint``)
                       — ``kind='torn_write'`` truncates the temp file
                       mid-byte first, simulating a kill mid-write
``telemetry.emit``     inside ``telemetry.events.EventLog.emit`` —
                       ``kind='torn_write'`` appends a partial JSON prefix
                       (no newline) before raising: the torn-tail shape
                       ``read_events(allow_partial_tail=True)`` tolerates
``stream.load``        inside the sanitizing CSV loader
                       (``io.sanitize.load_csv_sane``) — the home of the
                       **data-corruption kinds** ``nan_cell`` /
                       ``bad_label`` / ``ragged_row``, which mutate the
                       raw CSV text lines deterministically instead of
                       raising, so the dirty-stream machinery (doctor,
                       quarantine, repair) is exercised by the same
                       seeded injection the process faults use
``serve.ingress``      per admitted line block in the serving daemon's
                       ingress (``serve.admission.AdmissionController``)
                       — corruption kinds mutate the incoming protocol
                       lines (dirty live traffic); ``raise``/``timeout``
                       poison the batcher, crashing the daemon loudly
``serve.flush``        per flushed microbatch, at verdict publication
                       (``serve.runner.ServeRunner``) — ``raise`` kills
                       the daemon after the chunk's state advanced but
                       before its verdict/checkpoint landed (the
                       kill-and-resume shape); ``kind='torn_write'``
                       tears the verdict sidecar's trailing line;
                       ``kind='stall',seconds=S`` genuinely sleeps the
                       serve loop for S seconds (the wedge the SLO
                       ``stall_s`` rule and ops ``/healthz`` must catch)
``sched.lease``        per lease grant in the sweep scheduler
                       (``sched.scheduler.Scheduler``) — ``raise``
                       rejects that one grant (the worker retries, the
                       cell stays queued, the daemon survives);
                       ``kind='stall',seconds=S`` wedges the grant
``sched.worker``       per leased cell at execution start in the worker
                       agent (``sched.worker.Worker.run``), OUTSIDE the
                       per-cell error handling — ``raise`` kills the
                       whole agent process, the deterministic worker
                       preemption the exactly-once acceptance test and
                       the sched-smoke CI job arm via ``DDD_FAULTS``
                       (Bernoulli arming de-correlates per worker: the
                       agent re-seeds with its ``--index``)
=====================  ====================================================

Arming is explicit (:func:`arm` in-process, or the ``DDD_FAULTS`` env var
via :func:`arm_from_env` for CLI-driven sweeps) and deterministic: either
positional — fire on the ``at``-th invocation of the site, for ``times``
consecutive invocations — or seeded-Bernoulli (``rate`` + ``seed``: the
decision hashes ``(seed, site, hit)``, so a given arming fires at the same
hits in every run). No global RNG, no wall-clock.

Pure stdlib; importing this module never arms anything. The port fires
every site below.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .policy import TransientError, _unit_interval


class InjectedFault(TransientError):
    """A deliberately injected failure. Subclasses ``TransientError`` so
    the default :class:`..policy.RetryPolicy` classification retries it —
    an injected crash stands in for the transient cluster failure the
    subsystem exists to survive."""


class InjectedTimeout(InjectedFault):
    """The simulated-timeout fault (``kind='timeout'``): stands in for an
    attempt that would have exceeded its wall-clock budget, without
    actually sleeping."""


ENV_VAR = "DDD_FAULTS"

KINDS = (
    "raise", "timeout", "stall", "torn_write",
    "nan_cell", "bad_label", "ragged_row",
)

# Data-corruption kinds: instead of raising, a firing mutates the CSV text
# lines the ``stream.load`` site hands in — ``times`` is reinterpreted as
# *rows corrupted per firing* (default 1), and a positionally-armed spec
# fires on every load from ``at`` onward (the corruption is deterministic,
# so repeated loads corrupt identically). Only meaningful at sites that
# pass ``lines=``; elsewhere a corruption-kind firing is a no-op.
CORRUPTION_KINDS = frozenset({"nan_cell", "bad_label", "ragged_row"})

# Every site a production call point declares; arming anything else is a
# typo and fails loudly (the silent-no-op failure mode of a misspelled
# site name would defeat the whole point of a fault test).
SITES = frozenset(
    {
        "api.run",
        "grid.cell",
        "chunked.feed",
        "soak.leg",
        "checkpoint.save",
        "telemetry.emit",
        "stream.load",
        "serve.ingress",
        "serve.flush",
        "sched.lease",
        "sched.worker",
    }
)


@dataclass
class FaultSpec:
    """One armed site. ``at``/``times`` are positional arming (fire on
    hits ``[at, at + times)``; ``times=0`` = from ``at`` onward forever);
    ``rate``/``seed`` (with ``at=0``) are seeded-Bernoulli arming."""

    site: str
    at: int = 1
    times: int = 1
    kind: str = "raise"
    rate: float = 0.0
    seed: int = 0
    # kind='stall' only: how long the firing site really sleeps. Unlike
    # 'timeout' (which *stands in* for a blown budget by raising
    # immediately), a stall genuinely wedges the calling thread — the
    # shape the serving SLO engine's `stall_s` rule and the watch CLI's
    # stall contract exist to detect.
    seconds: float = 5.0
    hits: int = 0  # invocations of the site seen since arming
    fired: int = 0  # faults actually raised

    def should_fire(self) -> bool:
        if self.kind in CORRUPTION_KINDS:
            # Corruption kinds: `times` means rows-per-firing, not
            # consecutive-firing count — positional arming fires on every
            # hit from `at` onward (deterministic, so re-loads corrupt
            # identically); Bernoulli arming decides per hit as usual.
            if self.at:
                return self.hits >= self.at
            return (
                self.rate > 0.0
                and _unit_interval(self.seed, self.site, self.hits) < self.rate
            )
        if self.at:
            if self.hits < self.at:
                return False
            return self.times == 0 or self.fired < self.times
        if self.rate > 0.0:
            if self.times and self.fired >= self.times:
                return False
            return _unit_interval(self.seed, self.site, self.hits) < self.rate
        return False


_ARMED: dict[str, FaultSpec] = {}


def arm(
    site: str,
    *,
    at: "int | None" = None,
    times: int = 1,
    kind: str = "raise",
    rate: float = 0.0,
    seed: int = 0,
    seconds: float = 5.0,
) -> FaultSpec:
    """Arm ``site``; returns the live spec (its counters update as the
    site is hit). Re-arming a site replaces its spec and resets counters.

    Positional (``at=``, default 1 when no ``rate``) and seeded-Bernoulli
    (``rate=`` + ``seed=``) arming are mutually exclusive: passing a
    ``rate`` selects Bernoulli mode outright, and combining it with a
    nonzero ``at`` is rejected rather than silently ignoring the rate."""
    if site not in SITES:
        raise ValueError(
            f"unknown fault site {site!r}; expected one of {sorted(SITES)}"
        )
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; expected one of {KINDS}")
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    if rate > 0.0 and at not in (None, 0):
        raise ValueError(
            "positional at= and Bernoulli rate= are mutually exclusive"
        )
    if at is None:
        at = 0 if rate > 0.0 else 1
    if at < 0 or times < 0:
        raise ValueError("at/times must be >= 0")
    if at == 0 and rate == 0.0:
        raise ValueError("arm needs a positional `at` or a Bernoulli `rate`")
    spec = FaultSpec(
        site=site, at=at, times=times, kind=kind, rate=rate, seed=seed,
        seconds=float(seconds),
    )
    _ARMED[site] = spec
    return spec


def disarm(site: str) -> None:
    _ARMED.pop(site, None)


def disarm_all() -> None:
    _ARMED.clear()


def armed(site: str) -> FaultSpec | None:
    return _ARMED.get(site)


def arm_from_env(spec: str | None = None) -> list[str]:
    """Arm sites from the ``DDD_FAULTS`` env var (or an explicit string):
    ``site:key=val,key=val`` entries separated by ``;`` — e.g.
    ``DDD_FAULTS="grid.cell:at=4"`` crashes the 4th sweep trial, and
    ``DDD_FAULTS="telemetry.emit:at=5,kind=torn_write"`` tears the 5th
    emitted event. Returns the armed site names ([] when unset/empty).
    Called by ``harness.grid.run_grid`` so CLI-driven sweeps can be
    crashed without writing Python; everything else requires in-process
    :func:`arm` calls.
    """
    if spec is None:
        spec = os.environ.get(ENV_VAR, "")
    sites = []
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        site, _, args = entry.partition(":")
        kw: dict = {}
        for pair in filter(None, (p.strip() for p in args.split(","))):
            key, _, val = pair.partition("=")
            if key in ("at", "times", "seed"):
                kw[key] = int(val)
            elif key in ("rate", "seconds"):
                kw[key] = float(val)
            elif key == "kind":
                kw[key] = val
            else:
                raise ValueError(
                    f"{ENV_VAR}: unknown key {key!r} in entry {entry!r}"
                )
        arm(site.strip(), **kw)
        sites.append(site.strip())
    return sites


def corrupt_lines(
    lines: list[str],
    kind: str,
    *,
    rows: int = 1,
    seed: int = 0,
    label_col: int = -1,
) -> list[tuple[int, int]]:
    """Deterministically corrupt ``rows`` distinct CSV data lines in place.

    ``kind='nan_cell'`` replaces one seeded cell with ``nan`` (a
    non-finite value the contract scan flags); ``'bad_label'`` makes the
    ``label_col`` field non-integral (``<y>.5``); ``'ragged_row'`` drops
    the last field. Row/column choices hash ``(seed, kind, k)`` — no
    global RNG, no wall-clock — and collisions probe linearly, so a given
    arming corrupts the same cells in every run. Returns the corrupted
    ``(row, column)`` pairs (column −1 for ragged rows). Also usable
    directly (the ``dirty-stream-smoke`` CI job corrupts a CSV copy with
    it); :func:`fire` routes ``stream.load`` firings here.
    """
    if kind not in CORRUPTION_KINDS:
        raise ValueError(
            f"unknown corruption kind {kind!r}; expected one of "
            f"{sorted(CORRUPTION_KINDS)}"
        )
    n = len(lines)
    if n == 0:
        return []
    out: list[tuple[int, int]] = []
    for k, r in enumerate(corrupt_row_indices(kind, n, rows, seed)):
        fields = lines[r].split(",")
        if kind == "ragged_row":
            fields = fields[:-1] if len(fields) > 1 else fields + ["0"]
            out.append((r, -1))
        elif kind == "bad_label":
            c = label_col % len(fields)
            try:
                base = int(float(fields[c]))
            except ValueError:
                base = 0
            fields[c] = f"{base}.5"
            out.append((r, c))
        else:  # nan_cell
            c = corrupt_cell_column(kind, seed, k, len(fields))
            fields[c] = "nan"
            out.append((r, c))
        lines[r] = ",".join(fields)
    return out


def corrupt_row_indices(kind: str, n: int, rows: int, seed: int) -> list[int]:
    """The seeded distinct-row selection behind :func:`corrupt_lines` —
    the ONE copy of the hash keys and linear collision probing. The
    loadgen v2 columnar stand-ins (``serve.loadgen.apply_dirty_frames``)
    reuse it so a v1 and a v2 replay of the same ``--dirty`` spec dirty
    the SAME stream positions — the cross-protocol verdict-parity
    contract the ingress-v2-smoke CI job pins."""
    out: list[int] = []
    used: set[int] = set()
    for k in range(min(max(rows, 1), n)):
        r = int(_unit_interval(seed, f"{kind}.row", k) * n) % n
        while r in used:
            r = (r + 1) % n
        used.add(r)
        out.append(r)
    return out


def corrupt_cell_column(kind: str, seed: int, k: int, num_fields: int) -> int:
    """The seeded column choice for the ``k``-th ``nan_cell`` corruption
    (shared with the loadgen v2 stand-ins, like :func:`corrupt_row_indices`)."""
    return int(_unit_interval(seed, f"{kind}.col", k) * num_fields) % num_fields


def fire(site: str, *, file: str | None = None, fh=None, payload: str | None = None, lines: "list[str] | None" = None, label_col: int = -1, **context) -> None:
    """Production-code hook: a no-op unless ``site`` is armed and its spec
    elects this hit. When it fires:

    * ``kind='raise'`` — raise :class:`InjectedFault`.
    * ``kind='timeout'`` — raise :class:`InjectedTimeout`.
    * ``kind='torn_write'`` — first *tear the write the site is about to
      finish*: with ``fh``+``payload`` (the telemetry sink) append the
      first half of the payload with no newline; with ``file`` (the
      checkpoint temp file) truncate it to half its bytes; then raise.
    * corruption kinds (``nan_cell``/``bad_label``/``ragged_row``) —
      mutate ``lines`` (raw CSV data lines, no header) in place via
      :func:`corrupt_lines` and return **without raising**: the dirt
      flows through the sanitizing loader like real dirt would.
      ``label_col`` tells ``bad_label`` which field is the target.

    ``context`` rides into the exception message for post-mortems.
    """
    if not _ARMED:
        return
    spec = _ARMED.get(site)
    if spec is None:
        return
    spec.hits += 1
    if not spec.should_fire():
        return
    spec.fired += 1
    if spec.kind in CORRUPTION_KINDS:
        if lines is not None:
            corrupt_lines(
                lines,
                spec.kind,
                rows=max(spec.times, 1),
                seed=spec.seed,
                label_col=label_col,
            )
        return
    if spec.kind == "stall":
        # A real wedge, not a raise: the site's thread sleeps and then
        # continues normally — observable only by the staleness it causes
        # (SLO `stall_s`, `watch --stall-after`), exactly as in the field.
        import time as _time

        _time.sleep(max(spec.seconds, 0.0))
        return
    detail = f"injected fault at {site!r} (hit {spec.hits})"
    if context:
        detail += " " + " ".join(f"{k}={v!r}" for k, v in sorted(context.items()))
    if spec.kind == "timeout":
        raise InjectedTimeout(detail)
    if spec.kind == "torn_write":
        if fh is not None and payload is not None:
            fh.write(payload[: max(len(payload) // 2, 1)])
            fh.flush()
        elif file is not None and os.path.exists(file):
            size = os.path.getsize(file)
            with open(file, "r+b") as tfh:
                tfh.truncate(size // 2)
        raise InjectedFault(detail + " (write torn)")
    raise InjectedFault(detail)
