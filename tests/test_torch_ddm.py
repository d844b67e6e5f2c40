"""The port's DDM against the JAX package's, bit for bit.

``ddm_window`` on CPU tensors is the plain PyTorch version of kernel K1; it
must give the same end state and first-warning/first-change indices as
``jax.vmap(ddm_window)`` on the same numpy-seeded inputs, bit for bit —
carried ``inf`` minima, all-padding windows and the DDM_ROBUST noise floor
included. ``ddm_step`` is held against ``tests/oracle.py``'s OracleDDM and
the DDM entries of ``tests/golden/traces.json``. The kernel itself
runs only on the card (``tests/test_torch_kernels.py``).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_drift_detection_tpu.config import DDM_ROBUST as J_ROBUST  # noqa: E402
from distributed_drift_detection_tpu.config import DDMParams as JParams  # noqa: E402
from distributed_drift_detection_tpu.ops import ddm as jddm  # noqa: E402
from distributed_drift_detection_tpu_torch import convert  # noqa: E402
from distributed_drift_detection_tpu_torch.config import DDM_ROBUST, DDMParams  # noqa: E402
from distributed_drift_detection_tpu_torch.ops import ddm as tddm  # noqa: E402

from oracle import OracleDDM  # noqa: E402

PARAMS = {
    "classic": (DDMParams(), JParams()),
    "robust": (DDM_ROBUST, J_ROBUST),
    "warmup30": (DDMParams(min_num_instances=30), JParams(min_num_instances=30)),
}

_jax_window = jax.jit(
    jax.vmap(jddm.ddm_window, in_axes=(0, 0, 0, None)), static_argnums=3
)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _inputs(seed, p=6, w=5, b=20):
    """Error indicators with per-partition rate jumps, and validity with
    ragged padding; partition 1 is all padding."""
    rng = np.random.default_rng(seed)
    n = w * b
    flip = rng.integers(0, n, p)[:, None]
    rate = np.where(np.arange(n)[None] < flip, rng.uniform(0, 0.1, (p, 1)),
                    rng.uniform(0.3, 0.9, (p, 1)))
    errs = (rng.random((p, n)) < rate).astype(np.float32).reshape(p, w, b)
    valid = rng.random((p, w, b)) < 0.9
    valid[1] = False
    valid[2, -2:] = False
    return errs, valid


def _carried_state(seed, p, jparams):
    """Reachable carried states: run one earlier window through JAX. The
    warm-up gate of 'warmup30' leaves some rows with ps_min = inf but a
    finite p_min/s_min payload (the window's tie rule)."""
    errs, valid = _inputs(seed + 1000, p=p, w=1, b=25)
    init = jax.vmap(lambda _: jddm.ddm_init())(jnp.arange(p))
    state, _ = _jax_window(init, jnp.asarray(errs), jnp.asarray(valid), jparams)
    return state


def _both(seed, which, carried):
    params, jparams = PARAMS[which]
    errs, valid = _inputs(seed)
    p = errs.shape[0]
    if carried:
        jstate = _carried_state(seed, p, jparams)
    else:
        jstate = jax.vmap(lambda _: jddm.ddm_init())(jnp.arange(p))
    jend, jres = _jax_window(jstate, jnp.asarray(errs), jnp.asarray(valid), jparams)
    tend, tres = tddm.ddm_window(
        convert.ddm_state(jstate), torch.from_numpy(errs),
        torch.from_numpy(valid), params,
    )
    return (jend, jres), (tend, tres), jstate


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("which", sorted(PARAMS))
@pytest.mark.parametrize("seed", range(4))
def test_window_matches_jax_bitwise(seed, which, carried):
    (jend, jres), (tend, tres), _ = _both(seed, which, carried)
    for f in jddm.DDMState._fields:
        np.testing.assert_array_equal(
            _bits(getattr(jend, f)), _bits(getattr(tend, f).numpy()), err_msg=f
        )
    np.testing.assert_array_equal(np.asarray(jres.first_change), tres.first_change.numpy())
    np.testing.assert_array_equal(np.asarray(jres.first_warning), tres.first_warning.numpy())


def test_window_inputs_cover_the_hard_cases():
    """The parametrized inputs really reach what the window semantics turn
    on: detections and warnings, an all-padding row, and a carried state
    whose ps_min is inf with a finite p_min payload."""
    (jend, jres), _, jstate = _both(0, "warmup30", True)
    assert (np.asarray(jres.first_change) >= 0).any()
    (_, jres2), _, _ = _both(1, "classic", False)
    assert (np.asarray(jres2.first_warning) >= 0).any()
    ps, pm = np.asarray(jstate.ps_min), np.asarray(jstate.p_min)
    assert (np.isinf(ps) & np.isfinite(pm)).any()
    # the all-padding row keeps its count and gains nothing
    assert int(np.asarray(jend.count)[1]) == int(np.asarray(jstate.count)[1])


def test_window_dispatches_to_plain_on_cpu():
    errs, valid = _inputs(7)
    state = tddm.ddm_init((errs.shape[0],))
    before = tddm.ddm_window.launches
    a = tddm.ddm_window(state, torch.from_numpy(errs), torch.from_numpy(valid))
    b = tddm.ddm_window_reference(state, torch.from_numpy(errs), torch.from_numpy(valid))
    assert tddm.ddm_window.launches == before  # CPU tensors launch nothing
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


def _oracle(params):
    return OracleDDM(
        min_num_instances=params.min_num_instances,
        warning_level=params.warning_level,
        out_control_level=params.out_control_level,
        noise_floor=params.noise_floor,
    )


@pytest.mark.parametrize("which", ["classic", "robust"])
@pytest.mark.parametrize("seed", range(3))
def test_step_matches_oracle(seed, which):
    params = PARAMS[which][0]
    rng = np.random.default_rng(50 + seed)
    errs = (rng.random(250) < np.where(np.arange(250) < 150, 0.05, 0.6)).astype(np.float32)
    o = _oracle(params)
    state = tddm.ddm_init()
    for e in errs:
        o.add_element(float(e))
        state, (warn, change) = tddm.ddm_step(state, torch.tensor(e), params)
        assert bool(warn) == o.in_warning and bool(change) == o.in_change
    assert int(state.count) == o.count
    assert float(state.err_sum) == pytest.approx(o.err_sum)
    assert float(state.p_min) == pytest.approx(o.p_min, rel=1e-6)


def _golden_ddm_cases():
    path = os.path.join(os.path.dirname(__file__), "golden", "traces.json")
    with open(path) as fh:
        return [c for c in json.load(fh) if c["detector"] == "ddm"]


@pytest.mark.parametrize("case", _golden_ddm_cases(), ids=lambda c: c["case"])
def test_step_matches_golden_trace(case):
    s = case["stream"]
    rng = np.random.default_rng(s["seed"])
    probs = np.where(np.arange(s["n"]) < s["flip_at"], s["p0"], s["p1"])
    errs = (rng.random(s["n"]) < probs).astype(np.float32)
    params = DDMParams(**case["params"])
    state = tddm.ddm_init()
    warns, changes = [], []
    for i, e in enumerate(errs):
        state, (warn, change) = tddm.ddm_step(state, torch.tensor(e), params)
        if warn:
            warns.append(i)
        if change:
            changes.append(i)
    assert changes == case["changes"]
    assert warns == case["warnings"]
