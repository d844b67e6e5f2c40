"""Drift-triggered live refit: the reaction arm of the serving plane.

The port's twin of the JAX package's ``adapt/refit.py``. On a published
drift verdict for tenant *t* (policy ``retrain`` or ``shadow``), the
:class:`AdaptationController`:

1. **accumulates** a post-drift window of that tenant's admitted rows
   (host-side, from the sealed chunks' numpy copies — rows *after* the
   firing position, so the window samples the new concept only);
2. **refits** the classifier on the full window with one fit of the window
   as one partition ``[1, W, F]`` (kernel K7 for the centroid; K8/K9 for
   the mlp, K11 for the forest) on the detector's device, and scores
   champion (the tenant's current per-partition params) against the
   challenger on the same window in one launch of the model's fused
   ``predict_err`` (:mod:`.shadow`);
3. **applies** the winner at a chunk boundary by *data surgery* on the
   detector carry: a new :class:`~..engine.loop.LoopCarry` whose tenant
   slice ``[lo, lo+P)`` holds the window fit, a detector state
   re-initialised by the detector's own ``init``, ``batch_a`` the window's
   tail microbatch, and ``retrain = False`` — the paper-exact post-drift
   reset (*a ← b*, reset, retrain; ``DDM_Process.py:75-92`` steps 2-3) at
   window granularity. Every leaf is written into a copy, never into a
   tensor of the old carry, so the serve loop's entry-state clone and a
   chunk already in flight keep reading what they read.

The keys are the JAX package's: ``key(seed + 0xADA27)``, then
``fold_in(fold_in(base, t), adaptations)`` a refit (``utils/threefry.py``),
so the keyed refits (``mlp``, ``forest``) draw JAX's keys bit for bit.
:meth:`AdaptationController.prepare` runs every adaptation op once on zeros
of the window's shape before traffic, so no kernel builds and no launch
plan is chosen inside the serve loop.

The controller is engine-level, not serve-level: ``ServeRunner`` routes
published verdicts through it, and ``ChunkedDetector(on_drift=...)`` gives
the offline chunked loop the same hook. :meth:`~AdaptationController.on_chunk`
is the only place that launches adaptation kernels, on the thread that
feeds the detector; :meth:`~AdaptationController.snapshot` reads host
fields only.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..engine.chunked import _tree_map
from ..engine.loop import device_keys
from ..utils import threefry
from ..utils.checkpoint import _flatten, _unflatten
from .policy import (
    AdaptPolicy,
    resolve_cooldown_rows,
    resolve_window_rows,
)
from .shadow import (
    make_pair_scorer,
    pair_errors,
    should_demote,
    should_promote,
    stack_sides,
    window_table,
)

ADAPT_METRIC = "adaptations_total"
ADAPT_HELP = "Applied/held/demoted drift adaptations by tenant and policy"
ACTIVE_METRIC = "adaptation_active"
ACTIVE_HELP = "Tenants currently accumulating or probing an adaptation"
RECOVERY_METRIC = "adaptation_recovery_rows"
RECOVERY_HELP = (
    "Rows from drift verdict to post-drift error back within epsilon of "
    "the pre-drift level"
)

ADAPT_STATE_SUFFIX = ".adapt"

#: EWMA weight of the newest chunk error in the pre-drift baseline.
_EWMA_ALPHA = 0.2

#: The refit key's salt (the JAX package's ``key(seed + 0xADA27)``).
_KEY_SALT = 0xADA27


def _host_f32(X) -> np.ndarray:
    """A host feature plane as float32: a bfloat16 transport plane (its
    bits as uint16, ``io/stream.py``) widened exactly, as the JAX package's
    ``astype(np.float32)`` of its bfloat16 plane does."""
    X = np.asarray(X)
    if X.dtype == np.uint16:
        return (X.astype(np.uint32) << 16).view(np.float32)
    return X


def extract_tenant_rows(chunk, lo: int, hi: int, min_pos: int = -1):
    """One tenant's real rows from a sealed chunk's host copy, in stream
    order: ``(X [N, F], y [N])`` for valid rows with stream position
    strictly greater than ``min_pos`` (the post-drift filter on the
    trigger chunk; ``-1`` takes everything). Padding and quarantined
    rows are excluded — the refit window holds admitted data only."""
    rows = np.asarray(chunk.rows[lo:hi]).ravel()
    X = _host_f32(chunk.X[lo:hi]).reshape(rows.size, -1)
    y = np.asarray(chunk.y[lo:hi]).ravel()
    valid = np.asarray(chunk.valid[lo:hi]).ravel()
    keep = valid & (rows > min_pos)
    if not keep.any():
        return X[:0], y[:0]
    order = np.argsort(rows[keep], kind="stable")
    return (
        X[keep][order].astype(np.float32),
        y[keep][order].astype(np.int32),
    )


class WindowBuffer:
    """Fixed-capacity post-drift row accumulator (one per adapting
    tenant). Static capacity = static fit shapes = one launch plan."""

    def __init__(self, window_rows: int, num_features: int):
        self.capacity = int(window_rows)
        self.X = np.zeros((self.capacity, int(num_features)), np.float32)
        self.y = np.zeros(self.capacity, np.int32)
        self.n = 0

    @property
    def full(self) -> bool:
        return self.n >= self.capacity

    def add(self, X: np.ndarray, y: np.ndarray) -> None:
        take = min(len(X), self.capacity - self.n)
        if take > 0:
            self.X[self.n : self.n + take] = X[:take]
            self.y[self.n : self.n + take] = y[:take]
            self.n += take

    def arrays(self):
        """``(X, y, w)`` at full capacity shape; ``w`` masks the unfilled
        tail (the fit and the scorers are weight-masked throughout)."""
        w = np.zeros(self.capacity, np.float32)
        w[: self.n] = 1.0
        return self.X, self.y, w

    def reset(self) -> None:
        self.n = 0


class _TenantState:
    """One tenant's adaptation state machine (host-side bookkeeping)."""

    __slots__ = (
        "policy", "window_rows", "cooldown_rows", "phase", "buffer",
        "trigger_chunk", "trigger_rows", "trigger_wall", "cooldown_until",
        "pre_err", "champion", "watch_recovery", "recovered_rows",
        "recoveries", "applied_rows", "adaptations",
    )

    def __init__(self, policy: AdaptPolicy, rows_per_chunk: int,
                 num_features: int):
        self.policy = policy
        self.window_rows = resolve_window_rows(policy, rows_per_chunk)
        self.cooldown_rows = resolve_cooldown_rows(policy, self.window_rows)
        self.phase = "idle"  # idle | accum | probation
        self.buffer = (
            WindowBuffer(self.window_rows, num_features)
            if policy.active
            else None
        )
        self.trigger_chunk = -1
        self.trigger_rows = 0
        self.trigger_wall = 0.0
        self.cooldown_until = 0
        self.pre_err: "float | None" = None
        self.champion = None  # host param tree (CPU tensors) during probation
        self.watch_recovery = False
        self.recovered_rows: "int | None" = None  # latest completed watch
        self.recoveries: "list[int]" = []  # every completed watch
        self.applied_rows = 0
        self.adaptations = 0


def _scatter(leaf, sub, lo: int):
    """A copy of ``leaf`` with rows ``[lo, lo + len(sub))`` set to ``sub``
    (the carry's own leaf is never written)."""
    out = leaf.clone()
    out[lo : lo + sub.shape[0]] = sub.to(device=out.device, dtype=out.dtype)
    return out


class AdaptationController:
    """Consumes published drift verdicts and mutates the serving plane
    (see module docstring). One per daemon / chunked drain.

    ``det`` is the live :class:`~..engine.chunked.ChunkedDetector`;
    ``policies`` one :class:`~.policy.AdaptPolicy` per tenant;
    ``rows_per_chunk`` the per-tenant grid span (window auto-resolution
    unit); ``log`` an optional :class:`~..telemetry.events.EventLog`
    (``adaptation`` events + ``adaptation`` trace spans); ``metrics`` an
    optional registry (counters/gauges above). The kernels run on the
    detector's device.
    """

    def __init__(
        self,
        det,
        policies,
        *,
        per_batch: int,
        num_features: int,
        rows_per_chunk: int,
        log=None,
        metrics=None,
        seed: int = 0,
    ):
        if len(policies) != det.tenants:
            raise ValueError(
                f"{len(policies)} policies for {det.tenants} tenant(s)"
            )
        self.det = det
        self.device = det.device
        self.per_batch = int(per_batch)
        self.num_features = int(num_features)
        self.log = log
        self._seed = int(seed)
        self.states = [
            _TenantState(p, rows_per_chunk, num_features) for p in policies
        ]
        self._c_adapt = self._g_active = self._g_recovery = None
        if metrics is not None:
            self._c_adapt = metrics.counter(ADAPT_METRIC, help=ADAPT_HELP)
            self._g_active = metrics.gauge(ACTIVE_METRIC, help=ACTIVE_HELP)
            self._g_active.set(0)
            self._g_recovery = metrics.gauge(
                RECOVERY_METRIC, help=RECOVERY_HELP
            )
        self._base_key = threefry.key(self._seed + _KEY_SALT)
        self._score_pair = make_pair_scorer(det.model)

    @property
    def active(self) -> bool:
        """Whether any tenant's policy reacts (the runner skips the whole
        plane — construction included — when False)."""
        return any(s.policy.active for s in self.states)

    # -- the adaptation ops (static shapes; each prepared once) -------------

    def _fit_window(self, key: np.ndarray, X, y, w):
        """``model.fit`` of the window as one partition ``[1, W, F]``,
        expanded to the tenant's P partitions (``.contiguous()``: every
        partition serves the same fresh concept model)."""
        dev, p_per = self.device, self.det.tenant_partitions
        model = self.det.model
        Xt = torch.as_tensor(X, dtype=torch.float32).to(dev)[None].contiguous()
        yt = torch.as_tensor(y, dtype=torch.int32).to(dev)[None].contiguous()
        wt = torch.as_tensor(w, dtype=torch.float32).to(dev)[None].contiguous()
        k = device_keys(key[None], dev) if model.keyed else None
        params = model.fit(Xt, yt, wt, key=k)
        return _tree_map(
            lambda l: l.expand((p_per,) + tuple(l.shape[1:])).contiguous(), params
        )

    def _swap_full(self, carry, params_t, aX, ay, aw, lo: int):
        """The paper-exact post-drift reset at window granularity: fresh
        params, re-initialised detector, batch_a <- the window's tail
        microbatch, retrain off (the window fit must serve, not be
        overwritten by a batch_a refit next step). A new carry."""
        p_per, dev = self.det.tenant_partitions, self.device
        det_init = self.det._detector.init((p_per,), dev)
        tile = lambda a: torch.as_tensor(a).to(dev)[None].expand(
            (p_per,) + tuple(np.shape(a)))
        return carry._replace(
            params=_tree_map(lambda l, s: _scatter(l, s, lo), carry.params, params_t),
            ddm=_tree_map(lambda l, s: _scatter(l, s, lo), carry.ddm, det_init),
            a_X=_scatter(carry.a_X, tile(aX), lo),
            a_y=_scatter(carry.a_y, tile(ay), lo),
            a_w=_scatter(carry.a_w, tile(aw), lo),
            retrain=_scatter(
                carry.retrain, torch.zeros(p_per, dtype=torch.bool, device=dev), lo
            ),
        )

    def _swap_params(self, carry, params_t, lo: int):
        """Demotion restores the champion's params ONLY — the detector has
        been watching the live stream throughout and its state stays."""
        return carry._replace(
            params=_tree_map(lambda l, s: _scatter(l, s, lo), carry.params, params_t)
        )

    def _chunk_err(self, params, Xs, ys, valids, lo: int):
        """Post-publish chunk error of one tenant's slice ``[P, CB, B]``
        with its current params — the pre-drift baseline / recovery
        probe: each partition's rows through ``predict_err``,
        valid-weighted. Returns ``(err, n)`` float32 tensors."""
        p_per, dev = self.det.tenant_partitions, self.device
        params_t = _tree_map(lambda l: l[lo : lo + p_per], params)
        Xs = _host_f32(Xs)
        f = Xs.shape[-1]
        n_rows = Xs.size // f
        T, Ty = window_table(Xs.reshape(n_rows, f), np.asarray(ys).reshape(n_rows), dev)
        per = n_rows // p_per
        idx = torch.arange(n_rows, dtype=torch.int32, device=dev).view(p_per, per)
        v = torch.as_tensor(np.asarray(valids).reshape(p_per, per)).to(dev).float()
        err = self.det.model.predict_err(params_t, T, Ty, idx)
        n = v.sum()
        return (err * v).sum() / n.clamp_min(1.0), n

    def prepare(self, chunk_batches: "int | None" = None) -> None:
        """Run every adaptation op once before traffic, on zeros of the
        window's shape (the serving plane's prepared posture): the
        kernels build and their launch plans are chosen here, not inside
        the serve loop. The swaps run on a carry when one exists (a
        resumed daemon); their result is discarded."""
        p_per = self.det.tenant_partitions
        f = self.num_features
        for w_rows in sorted({s.window_rows for s in self.states
                              if s.policy.active}):
            X = np.zeros((w_rows, f), np.float32)
            y = np.zeros(w_rows, np.int32)
            w = np.zeros(w_rows, np.float32)
            params_t = self._fit_window(self._base_key, X, y, w)
            self._score_pair(stack_sides(params_t, params_t), X, y, w)
            if self.det.has_carry:
                aX = np.zeros((self.per_batch, f), np.float32)
                ay = np.zeros(self.per_batch, np.int32)
                aw = np.zeros(self.per_batch, np.float32)
                rows = self.det.carry_rows(0, p_per)
                self._swap_full(rows, params_t, aX, ay, aw, 0)
                self._swap_params(rows, params_t, 0)
        if chunk_batches and self.det.has_carry:
            shape = (p_per, int(chunk_batches), self.per_batch)
            self._chunk_err(
                self.det.carry_rows(0, p_per, "params"),
                np.zeros(shape + (f,), np.float32),
                np.zeros(shape, np.int32),
                np.zeros(shape, bool),
                0,
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the hook ------------------------------------------------------------

    def on_chunk(self, meta: dict, flags, chunk) -> None:
        """Route one published chunk through every adapting tenant's
        policy. ``meta`` is the sealed chunk's accounting dict (the
        batch path synthesizes ``{"chunk", "rows_through"}``), ``flags``
        the chunk's HOST flag table, ``chunk`` its host copy."""
        cg = np.asarray(flags.change_global)
        p_per = self.det.tenant_partitions
        t_through = meta.get("t_rows_through")
        for t, st in enumerate(self.states):
            if not st.policy.active:
                continue
            lo, hi = t * p_per, (t + 1) * p_per
            rows_through = int(
                t_through[t] if t_through is not None
                else meta["rows_through"]
            )
            err_chunk = self._tenant_chunk_err(chunk, lo)
            if st.watch_recovery and err_chunk is not None:
                if err_chunk <= (st.pre_err or 0.0) + st.policy.epsilon:
                    st.watch_recovery = False
                    st.recovered_rows = rows_through - st.trigger_rows
                    st.recoveries.append(st.recovered_rows)
                    if self._g_recovery is not None:
                        self._g_recovery.set(
                            st.recovered_rows, tenant=str(t)
                        )
            elif st.phase == "idle" and err_chunk is not None:
                st.pre_err = (
                    err_chunk
                    if st.pre_err is None
                    else (1 - _EWMA_ALPHA) * st.pre_err
                    + _EWMA_ALPHA * err_chunk
                )
            if st.phase in ("accum", "probation"):
                X, y = extract_tenant_rows(chunk, lo, hi)
                st.buffer.add(X, y)
                if st.buffer.full:
                    if st.phase == "accum":
                        self._refit(t, st, meta, rows_through)
                    else:
                        self._probe(t, st, meta, rows_through)
            elif st.phase == "idle":
                fired = cg[lo:hi]
                if (fired >= 0).any() and rows_through >= st.cooldown_until:
                    st.phase = "accum"
                    st.trigger_chunk = int(meta["chunk"])
                    st.trigger_rows = rows_through
                    st.trigger_wall = time.time()
                    st.buffer.reset()
                    st.watch_recovery = False
                    # the trigger chunk's own post-drift tail seeds the
                    # window
                    X, y = extract_tenant_rows(
                        chunk, lo, hi, int(fired[fired >= 0].max())
                    )
                    st.buffer.add(X, y)
                    if st.buffer.full:
                        self._refit(t, st, meta, rows_through)
        self._set_active_gauge()

    # -- internals -----------------------------------------------------------

    def _tenant_chunk_err(self, chunk, lo: int) -> "float | None":
        if chunk is None:
            return None
        p_per = self.det.tenant_partitions
        err, n = self._chunk_err(
            self.det.carry_rows(lo, lo + p_per, "params"),
            chunk.X[lo : lo + p_per],
            chunk.y[lo : lo + p_per],
            chunk.valid[lo : lo + p_per],
            0,
        )
        if float(n.cpu()) <= 0.0:
            return None
        return float(err.cpu())

    def _tenant_params(self, lo: int):
        """Tenant slice ``[lo, lo+P)`` of the carry's params, copied."""
        hi = lo + self.det.tenant_partitions
        return _tree_map(lambda l: l.clone(), self.det.carry_rows(lo, hi, "params"))

    def _next_key(self, t: int, st: _TenantState) -> np.ndarray:
        st.adaptations += 1
        # tenant-salted: two tenants at the same adaptation ordinal must
        # not share a refit key (key-consuming fits — mlp/forest — would
        # otherwise correlate across the plane)
        return threefry.fold_in(threefry.fold_in(self._base_key, t), st.adaptations)

    def _window_tail(self, st: _TenantState):
        """The window's last ``per_batch`` rows as the new ``batch_a``
        (*a ← b* at window granularity); short windows pad with zero
        weight."""
        B = self.per_batch
        n = st.buffer.n
        take = min(n, B)
        aX = np.zeros((B, self.num_features), np.float32)
        ay = np.zeros(B, np.int32)
        aw = np.zeros(B, np.float32)
        aX[:take] = st.buffer.X[n - take : n]
        ay[:take] = st.buffer.y[n - take : n]
        aw[:take] = 1.0
        return aX, ay, aw

    def _refit(self, t, st: _TenantState, meta, rows_through: int) -> None:
        lo = t * self.det.tenant_partitions
        n_window = st.buffer.n
        X, y, w = st.buffer.arrays()
        challenger = self._fit_window(self._next_key(t, st), X, y, w)
        champion = self._tenant_params(lo)
        err_before, err_after = pair_errors(
            self._score_pair, champion, challenger, X, y, w
        )
        promote = st.policy.on_drift == "retrain" or should_promote(
            err_before, err_after, st.policy.margin
        )
        if promote:
            aX, ay, aw = self._window_tail(st)
            hi = lo + self.det.tenant_partitions
            self.det.set_carry_rows(lo, self._swap_full(
                self.det.carry_rows(lo, hi), challenger, aX, ay, aw, 0
            ))
            st.applied_rows = rows_through
            st.watch_recovery = st.pre_err is not None
            if st.policy.on_drift == "shadow":
                # retain the deposed champion host-side for the
                # probation window's demotion gate
                st.champion = _tree_map(lambda l: l.cpu(), champion)
                st.phase = "probation"
                st.buffer.reset()
            else:
                st.phase = "idle"
                st.cooldown_until = rows_through + st.cooldown_rows
        else:
            st.phase = "idle"
            st.cooldown_until = rows_through + st.cooldown_rows
        self._emit(
            t, st, meta,
            rows_refit=n_window,
            err_before=err_before, err_after=err_after,
            promoted=bool(promote), rows_through=rows_through,
        )
        self._count(t, st, "promoted" if promote else "held")
        # the consumed window must not linger: /statusz would read a
        # full idle buffer as a stuck accumulation and every .adapt
        # checkpoint would persist the dead rows
        st.buffer.reset()

    def _probe(self, t, st: _TenantState, meta, rows_through: int) -> None:
        """Probation: the deposed champion scores the next window in
        shadow against the live challenger; a measured regression
        demotes the challenger (params-only restore)."""
        lo = t * self.det.tenant_partitions
        X, y, w = st.buffer.arrays()
        challenger = self._tenant_params(lo)
        champ = _tree_map(lambda l: l.to(self.device), st.champion)
        err_champ, err_chall = pair_errors(
            self._score_pair, champ, challenger, X, y, w
        )
        demote = should_demote(err_champ, err_chall, st.policy.margin)
        if demote:
            hi = lo + self.det.tenant_partitions
            self.det.set_carry_rows(
                lo, self._swap_params(self.det.carry_rows(lo, hi), champ, 0)
            )
            st.adaptations += 1  # snapshot/statusz must match the events
            self._emit(
                t, st, meta,
                rows_refit=st.buffer.n,
                err_before=err_champ, err_after=err_chall,
                promoted=False, rows_through=rows_through, demoted=True,
            )
            self._count(t, st, "demoted")
        st.champion = None
        st.phase = "idle"
        st.cooldown_until = rows_through + st.cooldown_rows
        st.buffer.reset()

    def _emit(self, t, st: _TenantState, meta, *, rows_refit, err_before,
              err_after, promoted, rows_through, **extra) -> None:
        if self.log is None:
            return
        self.log.emit(
            "adaptation",
            tenant=t,
            trigger_chunk=st.trigger_chunk,
            policy=st.policy.on_drift,
            rows_refit=int(rows_refit),
            err_before=err_before,
            err_after=err_after,
            promoted=bool(promoted),
            applied_chunk=int(meta["chunk"]),
            rows_to_apply=int(rows_through - st.trigger_rows),
            pre_drift_err=st.pre_err,
            window_rows=st.window_rows,
            **extra,
        )
        from ..telemetry.tracing import emit_span, new_trace_id

        now = time.time()
        emit_span(
            self.log,
            name="adaptation",
            trace_id=new_trace_id(),
            parent_id=None,
            start_ts=st.trigger_wall or now,
            dur_s=max(now - (st.trigger_wall or now), 0.0),
            tenant=t,
            policy=st.policy.on_drift,
            promoted=bool(promoted),
        )

    def _count(self, t, st: _TenantState, outcome: str) -> None:
        if self._c_adapt is not None:
            self._c_adapt.inc(
                1, tenant=str(t), policy=st.policy.on_drift, outcome=outcome
            )

    def _set_active_gauge(self) -> None:
        if self._g_active is not None:
            self._g_active.set(
                sum(1 for s in self.states if s.phase != "idle")
            )

    # -- observability surface ----------------------------------------------

    def snapshot(self) -> dict:
        """The ``/statusz`` adaptation section (host fields only)."""
        return {
            "policies": [s.policy.on_drift for s in self.states],
            "active": sum(1 for s in self.states if s.phase != "idle"),
            "adaptations": sum(s.adaptations for s in self.states),
            "tenants": [
                {
                    "tenant": t,
                    "phase": s.phase,
                    "window_rows": s.window_rows,
                    "buffered": s.buffer.n if s.buffer is not None else 0,
                    "pre_drift_err": s.pre_err,
                    "recovered_rows": s.recovered_rows,
                }
                for t, s in enumerate(self.states)
                if s.policy.active
            ],
        }

    def recovery_rows(self) -> "int | None":
        """Smallest measured drift→recovered span across tenants (the
        ``serve_adapt_recovery_rows`` bench cell); None until a
        recovery was observed."""
        spans = [r for s in self.states for r in s.recoveries]
        return min(spans) if spans else None

    # -- drain / resume ------------------------------------------------------

    def save(self, path: str) -> None:
        """Atomically persist the adaptation state (buffers, phases,
        retained champions) next to the detector checkpoint — the
        drain→resume contract for mid-adaptation state. The port's own
        ``.npz`` layout, with the JAX package's meta keys."""
        arrays: dict = {}
        states_meta = []
        for t, st in enumerate(self.states):
            m = {
                "phase": st.phase,
                "trigger_chunk": st.trigger_chunk,
                "trigger_rows": st.trigger_rows,
                "trigger_wall": st.trigger_wall,
                "cooldown_until": st.cooldown_until,
                "pre_err": st.pre_err,
                "watch_recovery": st.watch_recovery,
                "recovered_rows": st.recovered_rows,
                "recoveries": st.recoveries,
                "applied_rows": st.applied_rows,
                "adaptations": st.adaptations,
                "buffered": st.buffer.n if st.buffer is not None else 0,
                "champion": st.champion is not None,
            }
            states_meta.append(m)
            if st.buffer is not None and st.buffer.n:
                arrays[f"t{t}_bufX"] = st.buffer.X[: st.buffer.n]
                arrays[f"t{t}_bufy"] = st.buffer.y[: st.buffer.n]
            if st.champion is not None:
                for i, leaf in enumerate(_flatten(st.champion)):
                    arrays[f"t{t}_champ_{i}"] = leaf.numpy()
        arrays["__meta__"] = np.frombuffer(
            json.dumps({"v": 1, "states": states_meta}).encode(),
            dtype=np.uint8,
        )
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    def restore(self, path: str) -> bool:
        """Restore a :meth:`save`d state; returns False when ``path``
        does not exist (a fresh daemon). The detector carry must already
        be restored (champion templates come from it)."""
        if not os.path.exists(path):
            return False
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            states_meta = meta["states"]
            if len(states_meta) != len(self.states):
                raise ValueError(
                    f"adapt state {path!r} holds {len(states_meta)} "
                    f"tenant(s); this plane has {len(self.states)}"
                )
            for t, (st, m) in enumerate(zip(self.states, states_meta)):
                st.phase = m["phase"]
                st.trigger_chunk = int(m["trigger_chunk"])
                st.trigger_rows = int(m["trigger_rows"])
                st.trigger_wall = float(m["trigger_wall"])
                st.cooldown_until = int(m["cooldown_until"])
                st.pre_err = m["pre_err"]
                st.watch_recovery = bool(m["watch_recovery"])
                st.recovered_rows = m["recovered_rows"]
                st.recoveries = [int(r) for r in m.get("recoveries", [])]
                st.applied_rows = int(m["applied_rows"])
                st.adaptations = int(m["adaptations"])
                if st.buffer is not None:
                    st.buffer.reset()
                    if m["buffered"]:
                        st.buffer.add(
                            data[f"t{t}_bufX"], data[f"t{t}_bufy"]
                        )
                if m["champion"]:
                    assert self.det.has_carry, (
                        "adapt restore with a retained champion needs the "
                        "detector carry restored first"
                    )
                    template = self._tenant_params(
                        t * self.det.tenant_partitions
                    )
                    leaves = _flatten(template)
                    loaded = []
                    for i, want in enumerate(leaves):
                        got = data[f"t{t}_champ_{i}"]
                        if got.shape != tuple(want.shape):
                            raise ValueError(
                                f"adapt champion leaf shape {got.shape} != "
                                f"template {tuple(want.shape)}"
                            )
                        loaded.append(torch.from_numpy(np.array(got)).to(want.dtype))
                    st.champion = _unflatten(template, iter(loaded))
        self._set_active_gauge()
        return True
