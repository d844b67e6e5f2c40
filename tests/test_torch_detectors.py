"""The port's detector zoo against the JAX package's, bit for bit.

Every member's window and batch forms on CPU tensors (for Page–Hinkley,
HDDM-W and ADWIN the plain versions of kernels K5-ph, K5-hddm_w and
K5-adwin) must give the same end state and first-warning/first-change
indices as ``jax.vmap`` of the JAX package's, on the same numpy-seeded
padded streams, from fresh states and from states the JAX package carried
(converted through ``convert.detector_state``). Float leaves are compared
by their bits. The per-element masks are held against the NumPy oracles
of ``tests/test_detectors.py`` and every case of
``tests/golden/traces.json`` (ADWIN at ``clock=1`` against the textbook
``tests/classic.py``). The kernels themselves run only on the card
(``tests/test_torch_kernels.py``).
"""

import functools
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.ops import adwin as jadwin  # noqa: E402
from distributed_drift_detection_tpu.ops import detectors as jdet  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch import convert  # noqa: E402
from distributed_drift_detection_tpu_torch.ops import adwin as tadwin  # noqa: E402
from distributed_drift_detection_tpu_torch.ops import detectors as tdet  # noqa: E402
from distributed_drift_detection_tpu_torch.ops import prefix  # noqa: E402

from test_detectors import (  # noqa: E402
    OracleADWIN,
    OracleEDDM,
    OracleEDDMExact,
    OracleHDDM,
    OracleHDDMW,
    OracleKSWIN,
    OraclePH,
    OracleSTEPD,
    firsts,
    oracle_flags,
    planted_stream,
)

# (name, detector, params as keyword arguments of both packages' config
# classes); small windows so 100-element batches exercise full testing.
MEMBERS = {
    "ph": ("ph", "PHParams", dict(min_num_instances=5, delta=0.005, threshold=3.0, alpha=0.9)),
    "ph_classic": ("ph", "PHParams", dict(min_num_instances=5, delta=0.005, threshold=3.0)),
    "eddm": ("eddm", "EDDMParams", dict(min_num_errors=5)),
    "eddm_exact": ("eddm", "EDDMParams", dict(min_num_errors=5, paper_exact=True)),
    "hddm": ("hddm", "HDDMParams", {}),
    "hddm_w": ("hddm_w", "HDDMWParams", {}),
    "hddm_w_fast": ("hddm_w", "HDDMWParams", dict(lam=0.3)),
    "adwin": ("adwin", "ADWINParams", dict(max_levels=12, clock=4)),
    "adwin_default": ("adwin", "ADWINParams", {}),
    "kswin": ("kswin", "KSWINParams", dict(window_size=40, stat_size=10)),
    "stepd": ("stepd", "STEPDParams", dict(window_size=20)),
}
ORACLES = {
    "ph": OraclePH, "ph_classic": OraclePH, "eddm": OracleEDDM,
    "eddm_exact": OracleEDDMExact, "hddm": OracleHDDM, "hddm_w": OracleHDDMW,
    "hddm_w_fast": OracleHDDMW, "adwin": OracleADWIN, "adwin_default": OracleADWIN,
    "kswin": OracleKSWIN, "stepd": OracleSTEPD,
}


def _params(member):
    name, cls, kw = MEMBERS[member]
    return name, getattr(jconfig, cls)(**kw), getattr(tconfig, cls)(**kw)


def _jdetector(member):
    name, jp, _ = _params(member)
    return jdet.make_detector(name, **{name: jp})


def _tdetector(member):
    name, _, tp = _params(member)
    return tdet.make_detector(name, **{name: tp})


@functools.lru_cache(maxsize=None)
def _jax_fns(member):
    det = _jdetector(member)
    return (
        jax.jit(jax.vmap(det.window)),
        jax.jit(jax.vmap(det.batch)),
        jax.jit(jax.vmap(lambda _: det.init())),
    )


def _inputs(seed, p=4, w=5, b=20):
    """Error indicators with per-partition rate jumps and ragged padding;
    partition 1 all padding, partition 2 padded at the end."""
    rng = np.random.default_rng(seed)
    n = w * b
    flip = rng.integers(0, n, p)[:, None]
    rate = np.where(np.arange(n)[None] < flip, rng.uniform(0.0, 0.15, (p, 1)),
                    rng.uniform(0.3, 0.9, (p, 1)))
    errs = (rng.random((p, n)) < rate).astype(np.float32).reshape(p, w, b)
    valid = rng.random((p, w, b)) < 0.9
    valid[1] = False
    valid[2, -1, 5:] = False
    return errs, valid


def _carried(member, seed, p=4):
    """A reachable JAX state: one earlier window from a fresh state."""
    jwin, _, jinit = _jax_fns(member)
    e, v = _inputs(seed + 500, p=p)
    state, _ = jwin(jinit(jnp.arange(p)), jnp.asarray(e), jnp.asarray(v))
    return state


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_state(jstate, tstate):
    for f in jstate._fields:
        j, t = _bits(getattr(jstate, f)), _bits(getattr(tstate, f).numpy())
        assert j.dtype == t.dtype, f
        np.testing.assert_array_equal(j, t, err_msg=f)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_window_matches_jax_bitwise(member, carried):
    name = MEMBERS[member][0]
    jwin, _, jinit = _jax_fns(member)
    errs, valid = _inputs(sorted(MEMBERS).index(member))
    jstate = _carried(member, 3) if carried else jinit(jnp.arange(4))
    jend, jres = jwin(jstate, jnp.asarray(errs), jnp.asarray(valid))
    tend, tres = _tdetector(member).window(
        convert.detector_state(name, jstate), torch.from_numpy(errs), torch.from_numpy(valid)
    )
    _assert_same_state(jend, tend)
    for f in ("first_warning", "first_change"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)), getattr(tres, f).numpy())


@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_batch_matches_jax_bitwise(member):
    """The batch form (the window=1 engine's) from a carried state."""
    name = MEMBERS[member][0]
    _, jbatch, _ = _jax_fns(member)
    errs, valid = _inputs(7, w=1, b=60)
    jstate = _carried(member, 11)
    jend, jres = jbatch(jstate, jnp.asarray(errs[:, 0]), jnp.asarray(valid[:, 0]))
    tend, tres = _tdetector(member).batch(
        convert.detector_state(name, jstate),
        torch.from_numpy(errs[:, 0]), torch.from_numpy(valid[:, 0]),
    )
    _assert_same_state(jend, tend)
    for f in ("first_warning", "first_change"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)), getattr(tres, f).numpy())


def test_inputs_reach_every_outcome():
    """The parity inputs are not vacuous: across the members they give
    changes and warnings, and a carried state that differs from a fresh
    one."""
    changes = warnings = 0
    for member in MEMBERS:
        jwin, _, jinit = _jax_fns(member)
        errs, valid = _inputs(sorted(MEMBERS).index(member))
        _, res = jwin(_carried(member, 3), jnp.asarray(errs), jnp.asarray(valid))
        changes += int((np.asarray(res.first_change) >= 0).sum())
        warnings += int((np.asarray(res.first_warning) >= 0).sum())
    assert changes > 20 and warnings > 5


def _masks(member, errs, valid):
    """The port's per-element masks of one stream (a [1, N] row)."""
    name, _, tp = _params(member)
    fn = tadwin._adwin_masks if name == "adwin" else getattr(tdet, f"_{name}_masks")
    state = _tdetector(member).init((1,), "cpu")
    _, warn, change = fn(state, torch.from_numpy(errs)[None], torch.from_numpy(valid)[None], tp)
    return warn[0].numpy(), change[0].numpy()


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_masks_match_oracle(member, seed):
    """First warning and first change of the per-element masks equal the
    independent NumPy oracle's on a padded planted stream (the JAX
    package's own oracle test)."""
    rng = np.random.default_rng(seed)
    errs, valid = planted_stream(rng, 256, flip_at=128)
    ow, oc, _ = oracle_flags(ORACLES[member], _params(member)[1], errs, valid)
    warn, change = _masks(member, errs, valid)
    assert firsts(warn, change) == firsts(ow, oc)


def _golden_cases():
    path = os.path.join(os.path.dirname(__file__), "golden", "traces.json")
    with open(path) as fh:
        return [c for c in json.load(fh) if c["detector"] != "ddm"]


def _golden_stream(spec):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    try:
        import generate
    finally:
        sys.path.pop(0)
    return np.asarray(generate.make_stream(spec), np.float32)


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: c["case"])
def test_masks_match_golden_trace(case):
    """Every element's warning and change equal the committed trace
    (the ADWIN clock=1 cases are the textbook classic ADWIN's)."""
    name = case["detector"]
    params = getattr(tconfig, MEMBERS[name][1] if name in MEMBERS else "")(**case["params"])
    errs = _golden_stream(case["stream"])
    fn = tadwin._adwin_masks if name == "adwin" else getattr(tdet, f"_{name}_masks")
    init = tdet.make_detector(name, **{name: params}).init
    _, warn, change = fn(init((1,), "cpu"), torch.from_numpy(errs)[None],
                         torch.ones((1, len(errs)), dtype=torch.bool), params)
    assert np.flatnonzero(change[0].numpy()).tolist() == case["changes"]
    assert np.flatnonzero(warn[0].numpy()).tolist() == case["warnings"]


STEPS = {
    "ph": tdet.ph_step, "ph_classic": tdet.ph_step, "eddm": tdet.eddm_step,
    "eddm_exact": tdet.eddm_step, "hddm": tdet.hddm_step, "hddm_w": tdet.hddm_w_step,
    "hddm_w_fast": tdet.hddm_w_step, "adwin": tadwin.adwin_step,
    "adwin_default": tadwin.adwin_step, "kswin": tdet.kswin_step, "stepd": tdet.stepd_step,
}


@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_step_matches_oracle(member):
    """The per-element executable spec agrees with the oracle element by
    element (no reset, as the oracle runs)."""
    rng = np.random.default_rng(7)
    errs, _ = planted_stream(rng, 200, flip_at=100)
    ow, oc, _ = oracle_flags(ORACLES[member], _params(member)[1], errs, np.ones(200, bool))
    tp = _params(member)[2]
    state = _tdetector(member).init((1,), "cpu")
    warn, change = [], []
    for e in errs:
        state, (w, c) = STEPS[member](state, torch.tensor([e]), tp)
        warn.append(bool(w[0]))
        change.append(bool(c[0]))
    np.testing.assert_array_equal(warn, ow)
    np.testing.assert_array_equal(change, oc)


def _jax_ph_compose(first, second):
    a1, b1, k1 = first
    a2, b2, k2 = second
    return a2 * a1, a2 * b1 + b2, jnp.maximum(k2, a2 * k1 + b2)


def _jax_affine_compose(f, g):
    az1, bz1, av1, bv1 = f
    az2, bz2, av2, bv2 = g
    return az2 * az1, az2 * bz1 + bz2, av2 * av1, av2 * bv1 + bv2


@pytest.mark.parametrize("n", [1, 2, 7, 64, 100, 257, 1000, 4096])
def test_associative_scan_matches_lax_bitwise(n):
    """The plain scan evaluates lax.associative_scan's combine tree, so
    combines that round give the same bits on odd, even and power-of-two
    lengths: float addition, and Page–Hinkley's clamp-affine compose on
    its elements at α = 1 (padding is the identity, the clamp -1e30).

    HDDM-W's pair of affine maps is held to 2 ulp, not to the bit: XLA
    decides per fusion whether it contracts ``a*b + c`` into one FMA, and
    at lengths from about 200 a few of its scan elements come out of the
    unfused form (measured: at most 2 ulp from the fused tree). The flags
    and end states the tests compare are equal."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) * 1e3 ** rng.integers(-1, 2, (3, n))).astype(np.float32)
    want = jax.jit(jax.vmap(lambda v: lax.associative_scan(jnp.add, v)))(x)
    (got,) = prefix.associative_scan(lambda u, v: (u[0] + v[0],), (torch.from_numpy(x),))
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))

    valid = rng.random((3, n)) < 0.9
    a = np.ones((3, n), np.float32)
    b = np.where(valid, rng.normal(size=(3, n)), 0.0).astype(np.float32)
    k = np.where(valid, 0.0, -1e30).astype(np.float32)
    want = jax.jit(jax.vmap(lambda *e: lax.associative_scan(_jax_ph_compose, e)))(a, b, k)
    got = prefix.associative_scan(tdet._ph_compose, tuple(torch.from_numpy(e) for e in (a, b, k)))
    for w_, g in zip(want, got):
        np.testing.assert_array_equal(_bits(w_), _bits(g.numpy()))

    errs = torch.from_numpy((rng.random((3, n)) < 0.3).astype(np.float32))
    v = torch.from_numpy(valid)
    first = v & (torch.cumsum(v.int(), 1) == 1)
    elems = tdet._affine_elements(torch.zeros_like(v), first, v & ~first, errs,
                                  tdet.hddm_w_constants(tconfig.HDDMWParams()))
    want = jax.jit(jax.vmap(lambda *e: lax.associative_scan(_jax_affine_compose, e)))(
        *(e.numpy() for e in elems))
    got = prefix.associative_scan(tdet._affine_compose, elems)
    for w_, g in zip(want, got):
        ulps = np.abs(_bits(w_).astype(np.int64) - _bits(g.numpy()))
        assert ulps.max() <= 2 and (ulps == 0).mean() > 0.9


def test_fma_is_correctly_rounded():
    """``prefix.fma`` rounds ``a*b + c`` once: against exact rational
    arithmetic on values where two roundings differ."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(2000).astype(np.float32) for _ in range(2))
    c = (-(a.astype(np.float64) * b) * (1 + rng.uniform(-1e-7, 1e-7, 2000))).astype(np.float32)
    got = prefix.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    two = a * b + c
    assert (got != two).sum() > 100  # the cases where a fused result differs
    for x, y, z, g in zip(a[:500], b[:500], c[:500], got[:500]):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
        # nearest, ties to the even significand
        assert g == min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                              int(np.float32(v).view(np.int32)) & 1))


def test_ph_alpha_zero_with_padding():
    """alpha = 0 composed across padded elements stays finite and matches
    the step spec (the JAX package's NaN regression)."""
    params = tconfig.PHParams(min_num_instances=3, delta=0.0, threshold=0.5, alpha=0.0)
    errs = torch.tensor([[1, 0, 1, 1, 1, 1, 1, 1]], dtype=torch.float32)
    valid = torch.tensor([[True, False, True, True, False, True, True, True]])
    st = tdet.ph_init((1,))
    warn, change = np.zeros(8, bool), np.zeros(8, bool)
    for i in range(8):
        if valid[0, i]:
            st, (w, c) = tdet.ph_step(st, errs[:, i], params)
            warn[i], change[i] = bool(w[0]), bool(c[0])
    end, res = tdet.ph_window(tdet.ph_init((1,)), errs.view(1, 1, 8), valid.view(1, 1, 8), params)
    assert torch.isfinite(end.m).all()
    assert (int(res.first_warning[0, 0]), int(res.first_change[0, 0])) == firsts(warn, change)


def test_adwin_capacity_forgetting_matches_jax():
    """With max_levels = 3 the histogram forgets at capacity; the port
    walks the same bounded window as the JAX package, state and all."""
    kw = dict(max_levels=3, clock=4)
    rng = np.random.default_rng(11)
    errs = (rng.random((2, 900)) < 0.2).astype(np.float32)
    valid = np.ones((2, 900), bool)
    jp, tp = jconfig.ADWINParams(**kw), tconfig.ADWINParams(**kw)
    jend, jres = jax.vmap(lambda e, v: jadwin.adwin_batch(jadwin.adwin_init(jp), e, v, jp))(
        jnp.asarray(errs), jnp.asarray(valid))
    tend, tres = tadwin.adwin_batch(tadwin.adwin_init(tp, (2,)), torch.from_numpy(errs),
                                    torch.from_numpy(valid), tp)
    assert (tend.n < tend.t).all()  # forgetting happened
    _assert_same_state(jend, tend)
    np.testing.assert_array_equal(np.asarray(jres.first_change), tres.first_change.numpy())


def test_tree_prefix_is_a_fold_of_aligned_blocks():
    """The rule K5-hddm_w's cluster path builds its tree prefixes on
    (csrc/hddm_w_window.cu): ``lax.associative_scan``'s prefix of the first
    m elements is the left fold, most significant first, of the balanced
    combines of the aligned power-of-two blocks of m's binary expansion.
    Checked with a non-associative combine that records the pairing."""
    mod = (1 << 31) - 1

    def comb(a, b):
        return ((a[0] * 1000003 + b[0] * 999983 + 7) % mod,)

    def block(g, start, size):
        if size == 1:
            return g[start]
        half = size // 2
        return (block(g, start, half) * 1000003 + block(g, start + half, half) * 999983 + 7) % mod

    for n in range(1, 300):
        gt = torch.arange(1, n + 1, dtype=torch.int64) * 7919 % mod
        want = prefix.associative_scan(comb, (gt,))[0].tolist()
        g = gt.tolist()
        for m in range(1, n + 1):
            acc, start = None, 0
            for bit in range(m.bit_length() - 1, -1, -1):
                if (m >> bit) & 1:
                    v = block(g, start, 1 << bit)
                    acc = v if acc is None else (acc * 1000003 + v * 999983 + 7) % mod
                    start += 1 << bit
            assert acc == want[m - 1], (n, m)


def _fold_of_aligned_blocks(comb, elems, start=None):
    """Every inclusive prefix of ``elems`` (a tuple of [n] tensors) built as
    the zoo kernels' cluster paths build it (csrc/cluster_tree.cuh
    ``tree_prefixes``): the tree's values of the complete aligned blocks,
    level by level, then for each m the left fold of the blocks of m's
    binary expansion, most significant first — from the empty prefix, or,
    given ``start``, from that tuple composed in front."""
    n = elems[0].shape[0]
    levels = [elems]
    while levels[-1][0].shape[0] >= 2:
        lv, h = levels[-1], levels[-1][0].shape[0] // 2
        levels.append(comb(tuple(x[0:2 * h:2] for x in lv), tuple(x[1:2 * h:2] for x in lv)))
    m = torch.arange(1, n + 1)
    if start is None:
        acc, has = tuple(torch.zeros_like(x) for x in elems), torch.zeros(n, dtype=torch.bool)
    else:
        acc, has = tuple(torch.full_like(x, s) for x, s in zip(elems, start)), torch.ones(
            n, dtype=torch.bool)
    for bit in range(len(levels) - 1, -1, -1):
        take = ((m >> bit) & 1).bool()
        idx = (((m >> (bit + 1)) << (bit + 1)) >> bit).clamp(max=levels[bit][0].shape[0] - 1)
        val = tuple(x[idx] for x in levels[bit])
        step = tuple(torch.where(has, c, v) for c, v in zip(comb(acc, val), val))
        acc = tuple(torch.where(take, t, a) for t, a in zip(step, acc))
        has = has | take
    return acc


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.9999])
@pytest.mark.parametrize("n", [1, 2, 7, 255, 256, 257, 2049, 12800])
def test_ph_tree_prefix_fold_from_the_empty_prefix(n, alpha):
    """K5-ph's cluster path composes Page–Hinkley's maps as a fold of
    aligned blocks that starts from the empty prefix: bit for bit the plain
    scan (``lax.associative_scan``'s tree), from a carried state, with
    padding inside the row and, at alpha = 0.5 on long rows, the running
    product alpha^k flushed to 0. Starting the fold from the padding map
    (1, 0, -1e30) instead is not the same: where A is 0 that map's clamp
    turns max(K, A·m + B) into max(K, B), which differs at alpha = 0 on the
    row's first element (an error above the carried mean) — why the kernel
    carries a ``has`` flag rather than a synthetic identity."""
    rng = np.random.default_rng(n)
    valid = rng.random(n) < 0.9
    valid[n // 3: n // 3 + 5] = False  # a run of padding
    errs = (rng.random(n) < 0.3).astype(np.float32)
    valid[0], errs[0] = True, 1.0
    v, e = torch.from_numpy(valid), torch.from_numpy(errs)
    cnt = 40 + torch.cumsum(v.int(), 0, dtype=torch.int32)  # carried: 40 elements,
    xsum = 4.0 + torch.cumsum(e * v.float(), 0)  # 4 of them errors
    params = tconfig.PHParams(alpha=alpha)
    elems = (torch.where(v, prefix.f32(params.alpha), 1.0),
             torch.where(v, e - xsum / cnt.float() - prefix.f32(params.delta), 0.0),
             torch.where(v, 0.0, tdet._NO_CLAMP))
    want = prefix.associative_scan(tdet._ph_compose, elems)
    got = _fold_of_aligned_blocks(tdet._ph_compose, elems)
    for w_, g in zip(want, got):
        np.testing.assert_array_equal(_bits(w_.numpy()), _bits(g.numpy()))
    if alpha == 0.5 and n >= 2049:
        assert bool((want[0] == 0).any())  # alpha^k flushed inside the row
    if alpha == 0.0:
        padded = _fold_of_aligned_blocks(tdet._ph_compose, elems, start=(1.0, 0.0, tdet._NO_CLAMP))
        assert (_bits(want[2].numpy()) != _bits(padded[2].numpy())).any()


@pytest.mark.parametrize("p, n, ctas", [
    (16, 12800, 7), (1, 21, 1), (80, 21, 1), (80, 12800, 0), (16, 16384, 8),
    (16, 16385, 0), (67, 2048, 1), (67, 2049, 0), (1, 0, 0),
])
def test_hddm_w_path_choice(p, n, ctas):
    """K5-hddm_w and K5-ph take their cluster paths, ceil(N / 2048) CTAs a
    row, where they fit within K1's cluster size on 132 SMs, else their
    global-scratch paths (0): one shape rule for both."""
    assert tdet.cluster_ctas(p, n, 132) == ctas


@pytest.mark.parametrize("p, n, ctas", [
    (16, 12800, 7), (1, 12800, 7), (80, 21, 1), (80, 12800, 0), (3, 16000, 8),
    (3, 60000, 0), (16, 16384, 8), (16, 16385, 0), (16, 2048, 1), (16, 2049, 2),
])
@pytest.mark.parametrize("name", ["eddm", "hddm"])
def test_eddm_hddm_path_choice(name, p, n, ctas):
    """K5-eddm and K5-hddm take K5-ph's shape rule (``cluster_ctas`` on 132
    SMs): the SMOKE shape [16, 12,800] on a cluster of 7 CTAs, P = 1 too,
    clusters of one CTA at P = 80 and the one-CTA path for its long rows,
    EDDM's probe rows of 60,000 on the one-CTA path and of 16,000 on a full
    cluster, and 16,384 against 16,385. The launch arguments built for the
    path carry its CTAs a row where the launcher reads them, and K5-eddm's
    cluster path no scratch."""
    assert tdet.cluster_ctas(p, n, 132) == ctas
    args, state, _ = _zoo_args(name, 2, 1, 5, ctas=ctas)
    assert args[5 + len(state)] == ctas
    if name == "eddm":
        assert (args[10 + len(state)] is None) == (ctas > 0)  # the scratch
        if ctas:
            assert tdet.eddm_scratch(p, 1, n, ctas, "cpu") is None


@pytest.mark.parametrize("p, n, window_size, ctas", [
    (16, 12800, 100, 7), (16, 12800, 30, 7), (1, 12800, 2500, 7), (16, 12800, 2500, 7),
    (80, 21, 100, 1), (80, 12800, 100, 0), (16, 16384, 100, 8), (16, 16385, 100, 0),
    (67, 2048, 100, 1), (67, 2049, 100, 0), (2, 60000, 100, 0),
    (16, 12800, tdet.RING_WINDOW_CAP, 7), (16, 12800, tdet.RING_WINDOW_CAP + 1, 0),
])
@pytest.mark.parametrize("name", ["kswin", "stepd"])
def test_ring_path_choice(name, p, n, window_size, ctas):
    """K5-kswin and K5-stepd take K5-ph's shape rule (``cluster_ctas`` on 132
    SMs) while ``window_size`` is at most RING_WINDOW_CAP (16,384, the
    kernels' ``kWindowCap``: the carried window's prefix and a window's
    values below the CTA in every CTA's shared memory), else the one-CTA
    path: a function of ``(p, n, window_size)`` alone. The launch arguments built for the path carry
    its CTAs a row where the launcher reads them, and no scratch on the
    cluster path."""
    import re

    header = (Path(tdet.__file__).resolve().parent.parent / "csrc" / "ring_cluster.cuh")
    cap = re.search(r"constexpr int kWindowCap = (\d+);", header.read_text())
    assert cap and int(cap.group(1)) == tdet.RING_WINDOW_CAP == 16384
    assert tdet.ring_ctas(p, n, window_size, 132) == ctas
    if window_size <= tdet.RING_WINDOW_CAP:
        assert tdet.ring_ctas(p, n, window_size, 132) == tdet.cluster_ctas(p, n, 132)
    args, state, _ = _zoo_args(name, 2, 1, 5, ctas=ctas)
    assert args[5 + len(state)] == ctas
    assert (args[-5 if name == "kswin" else -6] is None) == (ctas > 0)  # the scratch
    if ctas:
        assert tdet.ring_scratch(f"{name}_window", p, 1, n, window_size, ctas, "cpu") is None


@pytest.mark.parametrize("ctas", [7, 0])
@pytest.mark.parametrize("name", ["ph", "hddm_w"])
def test_cluster_window_args_match_launch_signature(name, ctas):
    """K5-ph's and K5-hddm_w's launch arguments fit their ctypes
    signatures (kernels/__init__.py) one for one, in C type: the CTAs a row
    where the launcher reads them, and no scratch on the cluster path."""
    from distributed_drift_detection_tpu_torch import kernels

    p, w, b = 2, 4, 5
    params = {"ph": tconfig.PHParams(threshold=3.0), "hddm_w": tconfig.HDDMWParams()}[name]
    state = getattr(tdet, f"{name}_init")((p,))
    errs = torch.zeros((p, w, b), dtype=torch.float32)
    valid = torch.ones((p, w, b), dtype=torch.bool)
    fw = torch.empty((p, w), dtype=torch.int32)
    end = type(state)(*(torch.empty_like(leaf) for leaf in state))
    scratch = getattr(tdet, f"{name}_scratch")(p, w * b, ctas, "cpu")
    assert (scratch is None) == (ctas > 0)
    args = getattr(tdet, f"{name}_window_args")(state, errs, valid, params, fw, fw, end,
                                                scratch, ctas)
    types = kernels._SIGNATURES[f"{name}_window"][1]
    assert len(args) + 1 == len(types)  # the stream last
    kinds = {kernels._I: int, kernels._F: float}
    for arg, ctype in zip(args, types):
        if ctype is kernels._P:
            assert arg is None or isinstance(arg, int)
        else:
            assert type(arg) is kinds[ctype]
    assert args[2 + len(state) + 3] == ctas  # after errs, live, the state, p, w, b
    assert (args[types.index(kernels._P, 2 + len(state) + 4)] is None) == (ctas > 0)


def test_log_n_matches_xla_log():
    """ADWIN's ``ln n`` is XLA's CPU float32 log bit for bit on every n in
    [1, 2^22) (the JAX package's ``jnp.log`` of ``f32(max(n, 1))``)."""
    n = np.arange(1, 1 << 22, dtype=np.int32)
    want = np.asarray(jax.jit(jnp.log)(n.astype(np.float32))).view(np.int32)
    got = tadwin.log_n(torch.from_numpy(n)).numpy().view(np.int32)
    np.testing.assert_array_equal(got, want)
    # XLA's log is not correctly rounded; the float64 log would differ here
    assert (np.log(n.astype(np.float64)).astype(np.float32).view(np.int32) != want).any()


def _spread(n, k):
    """``k`` errors spread evenly over ``n`` elements (0/1 f32)."""
    e = np.zeros(n, np.float32)
    e[(np.arange(k) * n) // k] = 1
    return e


def c3_row():
    """One 11,936-element row from a fresh ADWIN state (default params):
    699 errors in the first 10,752 elements, 142 in the last 1,184. Its
    last flush (n = 11,936, total 841) has a bucket boundary at n0 =
    10,752, s0 = 699 whose cut test sits within an ulp of its bound: it
    fires with XLA's ``ln n`` and not with the correctly rounded one."""
    return np.concatenate([_spread(10752, 699), _spread(1184, 142)])[None]


def test_adwin_fires_on_xla_log_tie():
    """``adwin_batch`` on :func:`c3_row` fires at its last element, as the
    JAX package's does; a correctly rounded ``ln n`` would not fire."""
    errs = c3_row()
    valid = np.ones_like(errs, bool)
    jp, tp = jconfig.ADWINParams(), tconfig.ADWINParams()
    jend, jres = jax.vmap(lambda e, v: jadwin.adwin_batch(jadwin.adwin_init(jp), e, v, jp))(
        jnp.asarray(errs), jnp.asarray(valid))
    tend, tres = tadwin.adwin_batch(tadwin.adwin_init(tp, (1,)), torch.from_numpy(errs),
                                    torch.from_numpy(valid), tp)
    _assert_same_state(jend, tend)
    assert int(jres.first_change[0]) == int(tres.first_change[0]) == errs.shape[1] - 1
    n = torch.tensor([errs.shape[1]])
    assert not torch.equal(tadwin.log_n(n), torch.log(n.double()).float())


def _drift_late(seed, p, n, flip=0.8):
    """All-valid 0/1 rows: error rate 0.1, then 0.6 from ``flip`` of the row."""
    rng = np.random.default_rng(seed)
    rate = np.where(np.arange(n)[None] < int(flip * n), 0.1, 0.6)
    return (rng.random((p, n)) < rate).astype(np.float32), np.ones((p, n), bool)


# ADWINParams keyword arguments and row length: > 32 occupied bucket
# boundaries with slots in registers (C = 8) and in shared memory (C = 13)
# in kernel K5-adwin, and a row shorter than one chunk (no flush).
ADWIN_SHAPES = {
    "over_32_boundaries": (dict(max_buckets=7, max_levels=8, clock=2), 2000),
    "max_buckets_12": (dict(max_buckets=12, max_levels=8, clock=2), 2000),
    "no_flush": ({}, 31),
}


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("case", sorted(ADWIN_SHAPES))
def test_adwin_histogram_shapes_match_jax(case, carried):
    """The plain version of K5-adwin against ``jax.vmap`` of the JAX
    package's ``adwin_batch`` on the histogram shapes the kernel's paths
    split on, from a fresh state and from one carried over 64 elements."""
    kw, n = ADWIN_SHAPES[case]
    jp, tp = jconfig.ADWINParams(**kw), tconfig.ADWINParams(**kw)
    jbatch = jax.vmap(lambda s, e, v: jadwin.adwin_batch(s, e, v, jp))
    jstate = jax.vmap(lambda _: jadwin.adwin_init(jp))(jnp.arange(2))
    if carried:
        e0, v0 = _drift_late(3, 2, 64, flip=1.0)
        jstate, _ = jbatch(jstate, jnp.asarray(e0), jnp.asarray(v0))
    errs, valid = _drift_late(4, 2, n)
    jend, jres = jbatch(jstate, jnp.asarray(errs), jnp.asarray(valid))
    tend, tres = tadwin.adwin_batch(convert.detector_state("adwin", jstate),
                                    torch.from_numpy(errs), torch.from_numpy(valid), tp)
    _assert_same_state(jend, tend)
    np.testing.assert_array_equal(np.asarray(jres.first_change), tres.first_change.numpy())
    if case == "no_flush":
        np.testing.assert_array_equal(tend.t.numpy() // tp.clock, np.asarray(jstate.t) // tp.clock)
    else:
        assert int(tend.counts.sum(1).min()) > 32
        assert (tres.first_change >= 0).all()  # the cut fires with > 32 boundaries


def test_adwin_indicator_guard(monkeypatch):
    """The opt-in 0/1 guard raises on a real-valued valid error and lets
    masked ones through; off by default and for '0'/'false'."""
    real = torch.full((1, 1, 8), 0.5)
    ones = torch.ones((1, 1, 8), dtype=torch.bool)
    state = tadwin.adwin_init(tconfig.ADWINParams(), (1,))
    tadwin.adwin_window(state, real, ones)  # off: silently truncated
    for off in ("", "0", "false", "OFF", "no"):
        monkeypatch.setenv("DDD_DEBUG_INDICATORS", off)
        assert not tadwin._indicator_checks_enabled()
    monkeypatch.setenv("DDD_DEBUG_INDICATORS", "1")
    masked = torch.tensor([[[0.0, 0.5, 1.0, 2.0]]])
    tadwin.adwin_window(state, masked, torch.tensor([[[True, False, True, False]]]))
    with pytest.raises(ValueError, match="non-indicator"):
        tadwin.adwin_window(state, real, ones)


@pytest.mark.parametrize("name, kw, match", [
    ("ph", dict(alpha=1.5, threshold=1.0), "alpha"),
    ("ph", dict(alpha=-0.5, threshold=1.0), "alpha"),
    ("ph", dict(threshold=0.0), "threshold"),
    ("hddm", dict(drift_confidence=0.0), "drift_confidence"),
    ("hddm_w", dict(lam=0.0), "lam"),
    ("hddm_w", dict(lam=1.0), "lam"),
    ("hddm_w", dict(drift_confidence=1.5), "drift_confidence"),
    ("adwin", dict(delta=0.0), "delta"),
    ("adwin", dict(clock=0), "clock"),
    ("adwin", dict(max_buckets=1), "max_buckets"),
    ("adwin", dict(max_levels=31), "max_levels"),
    ("adwin", dict(max_levels=30), "int32"),
    ("adwin", dict(min_window=4, min_side=5), "min_side"),
    ("kswin", dict(alpha=0.0), "alpha"),
    ("kswin", dict(window_size=30, stat_size=30), "stat_size"),
    ("stepd", dict(alpha_drift=0.0), "alpha_drift"),
    ("stepd", dict(window_size=1), "window_size"),
])
def test_invalid_params_raise(name, kw, match):
    """make_detector and the window forms refuse what the JAX package
    refuses, with the same messages."""
    cls = {m[0]: m[1] for m in MEMBERS.values()}[name]
    params = getattr(tconfig, cls)(**kw)
    with pytest.raises(ValueError, match=match):
        jdet.make_detector(name, **{name: getattr(jconfig, cls)(**kw)})
    with pytest.raises(ValueError, match=match):
        tdet.make_detector(name, **{name: params})
    window = tadwin.adwin_window if name == "adwin" else getattr(tdet, f"{name}_window")
    init = {"adwin": lambda: tadwin.adwin_init(tconfig.ADWINParams(), (1,)),
            "kswin": lambda: tdet.kswin_init(tconfig.KSWINParams(), (1,)),
            "stepd": lambda: tdet.stepd_init(tconfig.STEPDParams(), (1,))}.get(
        name, lambda: getattr(tdet, f"{name}_init")((1,)))
    if name in ("ph", "hddm_w", "adwin", "kswin", "stepd"):
        with pytest.raises(ValueError, match=match):
            window(init(), torch.zeros((1, 2, 4)), torch.ones((1, 2, 4), dtype=torch.bool), params)


def test_unknown_detector_raises():
    with pytest.raises(ValueError, match="unknown detector"):
        tdet.make_detector("ecdd")


def test_zoo_windows_dispatch_to_plain_on_cpu():
    """On CPU tensors every zoo member's window wrapper runs its plain
    version (``*_window_reference``: the same bits) and launches nothing."""
    errs, valid = (torch.from_numpy(x) for x in _inputs(5))
    wrappers = {"ph": tdet.ph_window, "eddm": tdet.eddm_window, "hddm": tdet.hddm_window,
                "hddm_w": tdet.hddm_w_window, "kswin": tdet.kswin_window,
                "stepd": tdet.stepd_window, "adwin": tadwin.adwin_window}
    before = {k: fn.launches for k, fn in wrappers.items()}
    for member in ("ph", "eddm", "eddm_exact", "hddm", "hddm_w", "kswin", "stepd", "adwin"):
        name, _, tp = _params(member)
        det = _tdetector(member)
        state = det.init((4,), "cpu")
        reference = (tadwin.adwin_window_reference if name == "adwin"
                     else getattr(tdet, f"{name}_window_reference"))
        got = det.window(state, errs, valid)
        want = reference(state, errs, valid, tp)
        for g, r in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(r.numpy()))
    assert {k: fn.launches for k, fn in wrappers.items()} == before


def _zoo_args(name, p=2, w=4, b=5, ctas=0):
    """K5-eddm's, K5-hddm's, K5-kswin's or K5-stepd's launch arguments on CPU
    tensors (their wrappers' allocations, on the path ``ctas`` names; the
    one-CTA paths of K5-eddm, K5-kswin and K5-stepd with a global scratch),
    with the state they were built from."""
    params = {"eddm": tconfig.EDDMParams(paper_exact=True), "hddm": tconfig.HDDMParams(),
              "kswin": tconfig.KSWINParams(), "stepd": tconfig.STEPDParams()}[name]
    init = {"kswin": lambda: tdet.kswin_init(params, (p,)),
            "stepd": lambda: tdet.stepd_init(params, (p,))}.get(
        name, lambda: getattr(tdet, f"{name}_init")((p,)))
    state = init()
    errs = torch.zeros((p, w, b), dtype=torch.float32)
    valid = torch.ones((p, w, b), dtype=torch.bool)
    fw = torch.empty((p, w), dtype=torch.int32)
    end = type(state)(*(torch.empty_like(leaf) for leaf in state))
    rest = (fw, fw, end)
    if name == "eddm":
        scratch = None if ctas else torch.empty((p, tdet.eddm_tree_words(w * b)))
        args = tdet.eddm_window_args(state, errs, valid, params, *rest, scratch, ctas)
    elif name == "hddm":
        args = tdet.hddm_window_args(state, errs, valid, params, *rest, ctas)
    else:
        scratch = (tdet.ring_scratch(f"{name}_window", p, w, b, params.window_size, ctas, "cpu")
                   if ctas else torch.empty((p, params.window_size + w * b + 1)))
        args = getattr(tdet, f"{name}_window_args")(state, errs, valid, params, *rest, scratch,
                                                    ctas)
    return args, state, params


@pytest.mark.parametrize("name", ["eddm", "hddm", "kswin", "stepd"])
def test_zoo_window_args_match_launch_signature(name):
    """K5-eddm's, K5-hddm's, K5-kswin's and K5-stepd's launch arguments fit
    their ctypes signatures (kernels/__init__.py) one for one, in C type,
    with the shape where the launcher reads it and each float a float32;
    on both paths, the CTAs a row after the shape and the scratch (K5-eddm,
    K5-kswin, K5-stepd) null on the cluster path."""
    from distributed_drift_detection_tpu_torch import kernels

    types = kernels._SIGNATURES[f"{name}_window"][1]
    for ctas in (7, 0):
        args, state, _ = _zoo_args(name, ctas=ctas)
        assert len(args) + 1 == len(types)  # the stream last
        kinds = {kernels._I: int, kernels._F: float}
        for arg, ctype in zip(args, types):
            if ctype is kernels._P:
                assert arg is None or isinstance(arg, int)
            else:
                assert type(arg) is kinds[ctype]
                if ctype is kernels._F:
                    assert float(np.float32(arg)) == arg
        shape = args[2 + len(state):5 + len(state)]
        assert shape == (2, 4, 5)  # p, w, b after the state
        assert args[5 + len(state)] == ctas
        nulls = [a is None for a in args]
        assert any(nulls) == (name != "hddm" and ctas > 0)  # the scratch alone


@pytest.mark.parametrize("n, words", [(1, 0), (16, 0), (17, 2 * 2), (256, 2 * 16),
                                      (257, 2 * (17 + 2)), (12800, 2 * (800 + 50 + 4))])
def test_eddm_tree_words(n, words):
    """K5-eddm's scratch holds the levels of cumsum_f32's tree above the
    elements, for d and d²: ceil(n/16), then ceil(·/16) while a level holds
    more than 16."""
    assert tdet.eddm_tree_words(n) == words


@pytest.mark.parametrize("n", [1, 5, 16, 17, 300, 4097, 12800])
def test_cumsum_f32_matches_jax_bitwise(n):
    """``prefix.cumsum_f32`` is ``jnp.cumsum`` of float32 on the CPU bit for
    bit — blocks of 16 chained, the blocks' values scanned the same way —
    on real values of both signs and on EDDM-like squared distances, which
    pass 2^24 (a left-to-right chain and ``torch.cumsum`` both differ)."""
    rng = np.random.default_rng(n)
    real = (rng.standard_normal((3, n)) * 1e3).astype(np.float32)
    sq = np.where(rng.random((3, n)) < 0.05, rng.integers(1, 5000, (3, n)) ** 2, 0.0)
    for x in (real, sq.astype(np.float32)):
        want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(jnp.asarray(x)))
        got = prefix.cumsum_f32(torch.from_numpy(x), 1).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _chains16(x):
    """Left-to-right float32 chains over the aligned blocks of 16 along the
    last axis of ``x`` (a multiple of 16 long): [..., blocks, 16]."""
    blocks = x.reshape(*x.shape[:-1], -1, 16)
    out = np.empty_like(blocks)
    s = np.zeros(blocks.shape[:-1], np.float32)
    for r in range(16):
        s = s + blocks[..., r]
        out[..., r] = s
    return out


def _eddm_cluster_cumsum(x):
    """The cumsum of non-negative float32 ``x`` [n] (n <= 16,384) as
    K5-eddm's cluster path builds it (csrc/eddm_window.cu): the row cut into
    aligned segments of 2048 (a CTA each, zeros past n); in each, the
    chains of the blocks of 16 elements (a lane pair) and, per warp, the
    chain of its 16 block values, whose last is the warp's level-2 value;
    the levels from 256 elements up rebuilt from every segment's level-2
    values (chains over blocks of 16 of them, the chain of those blocks'
    last values); then each element's block chain added to the scanned
    value before its block with one rounding."""
    n = x.shape[0]
    ctas = -(-n // 2048)
    xs = np.zeros(ctas * 2048, np.float32)
    xs[:n] = x
    ch0 = _chains16(xs)  # [blocks, 16]
    ch1 = _chains16(ch0[:, -1])  # [warps, 16]
    t2 = ch1[:, -1]  # the warps' level-2 values: 8 a segment
    g_n = t2.shape[0]
    tops = np.zeros(-(-g_n // 16) * 16, np.float32)
    tops[:g_n] = t2
    ch2 = _chains16(tops)  # [level-3 blocks, 16]
    e3 = np.zeros(ch2.shape[0], np.float32)
    for h in range(1, ch2.shape[0]):
        e3[h] = e3[h - 1] + ch2[h - 1, -1]
    s2 = (e3[:, None] + ch2).reshape(-1)[:g_n]
    zero = np.zeros(1, np.float32)
    s2x = np.concatenate([zero, zero, s2])  # s2x[g + 1] = S2[g - 1], 0 before the row
    base = np.zeros(ch0.shape[0], np.float32)
    for k1 in range(ch0.shape[0]):
        g, i = divmod(k1, 16)
        if i > 0:
            base[k1] = s2x[g + 1] + ch1[g, i - 1]
        elif g > 0:
            base[k1] = s2x[g] + t2[g - 1]
    return (base[:, None] + ch0).reshape(-1)[:n]


@pytest.mark.parametrize("n", [17, 2048, 2049, 12800, 16384])
def test_eddm_cluster_tree_is_cumsum_f32(n):
    """The rule K5-eddm's cluster path rests on: ``cumsum_f32``'s tree (XLA's
    base-16 tree on the CPU) cut at aligned 2048-element segments, the
    levels from 256 elements up rebuilt from all segments' level-2 values,
    equals ``cumsum_f32`` and ``jnp.cumsum`` bit for bit on non-negative
    terms — EDDM's distances and their squares, past 2^24 — and on dense
    non-negative reals."""
    rng = np.random.default_rng(n)
    d = np.where(rng.random((3, n)) < 0.05, rng.integers(1, 5000, (3, n)), 0)
    dense = np.abs(rng.standard_normal((3, n)) * 1e3)
    for x in (d.astype(np.float32), (d * d).astype(np.float32), dense.astype(np.float32)):
        want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(jnp.asarray(x)))
        mine = prefix.cumsum_f32(torch.from_numpy(x), 1).numpy()
        np.testing.assert_array_equal(_bits(mine), _bits(want))
        for row, w_row in zip(x, want):
            np.testing.assert_array_equal(_bits(_eddm_cluster_cumsum(row)), _bits(w_row))


def _ring_cluster_model(buf, errs, valid):
    """The look-back of K5-kswin's and K5-stepd's cluster path
    (csrc/ring_cluster.cuh) in NumPy, one row: CTA r's ``loc``, the
    inclusive error counts at its valid elements in compaction order; every
    rank's valid and error bases; the carried window's prefix cp; and each
    CTA's ``ext``, ext[t] = ps[base_n + 1 + t] for t < wr, gathered from cp
    (k <= wr) or from the owner o of i = k − wr − 1, the last rank whose base
    is at most i (C + base_c[o] + loc_o[i − base_n[o]]). Returns ``ps(k,
    rank)`` — what an element of CTA ``rank`` reads at k: C + its CTA's base
    and ``loc`` where i is at least its CTA's base, else ``ext`` — and the
    next carried window (each element whose compaction index is at least
    nv − wr writes its place, rank 0 copies the rest of the old window)."""
    seg = tdet.CLUSTER_SEGMENT
    wr, n = buf.shape[0], errs.shape[0]
    cs = max(1, -(-n // seg))
    f = np.float32
    locs = np.zeros((cs, seg), f)
    cnt = np.zeros(cs, np.int64)
    err = np.zeros(cs, f)
    for r in range(cs):
        kept = errs[r * seg:(r + 1) * seg][valid[r * seg:(r + 1) * seg]]
        cnt[r] = kept.size
        c = f(0)
        for m, x in enumerate(kept):
            c = f(c + x)
            locs[r, m] = c
        err[r] = c
    base_n = np.concatenate([[0], np.cumsum(cnt)])
    base_c = np.zeros(cs + 1, f)
    for r in range(cs):
        base_c[r + 1] = f(base_c[r] + err[r])
    cp = np.zeros(wr + 1, f)
    for i in range(wr):
        cp[i + 1] = f(cp[i] + buf[i])
    carried, nv = cp[wr], int(base_n[cs])

    def gather(k):  # the ext rule, k > base_n of the reading CTA
        out = cp[np.minimum(k, wr)].copy()
        above = k > wr
        i = k[above] - wr - 1
        o = (base_n[1:cs][None, :] <= i[:, None]).sum(1)
        assert (cnt[o] > 0).all()  # a rank of padding only owns no index
        at = i - base_n[o]
        assert ((at >= 0) & (at < cnt[o])).all()
        out[above] = carried + (base_c[o] + locs[o, at])
        return out

    ext = np.stack([gather(base_n[r] + 1 + np.arange(wr)) for r in range(cs)])

    def ps(k, rank):
        i = k - wr - 1
        my = base_n[rank]
        own = i >= my
        out = np.empty(k.shape, f)
        out[own] = carried + (base_c[rank[own]] + locs[rank[own], (i - my)[own]])
        t = (k - my - 1)[~own]
        assert ((t >= 0) & (t < wr)).all()  # a window stays within ext
        out[~own] = ext[rank[~own], t]
        return out

    end = np.zeros(wr, f)
    q = 0
    for x in errs[valid]:
        if q - nv + wr >= 0:
            end[q - nv + wr] = x
        q += 1
    end[: max(0, wr - nv)] = buf[nv:nv + max(0, wr - nv)]
    return ps, end


def _ring_rows(seed, n, wr):
    """0/1 rows of ``n`` with (0) the second segment all padding (the
    third's windows reach two CTAs back), (1) the first segment all padding
    (later windows reach into the carried window), (2) fewer valid
    elements than the window, (3) all valid; and a carried window."""
    rng = np.random.default_rng(seed)
    seg = tdet.CLUSTER_SEGMENT
    errs = (rng.random((4, n)) < 0.3).astype(np.float32)
    valid = rng.random((4, n)) < 0.9
    valid[0, seg:2 * seg] = False
    valid[1, :seg] = False
    valid[2] = False
    valid[2, rng.choice(n, min(n, max(1, wr // 2)), replace=False)] = True
    valid[3] = True
    buf = (rng.random((4, wr)) < 0.4).astype(np.float32)
    return buf, errs, valid


@pytest.mark.parametrize("wr", [5, 30, 100, 2500])
@pytest.mark.parametrize("n", [7, 2048, 2049, 12800, 16384])
def test_ring_cluster_lookback_is_ring_compact(n, wr):
    """The rule K5-kswin's and K5-stepd's cluster path rests on: per-segment
    compacted prefixes, and each CTA's window of wr values below its own
    elements gathered through the owner rank's bases, equal the plain
    ``_ring_compact``'s ``ps`` bit for bit at every index an element reads — its own prefix, STEPD's and KSWIN's lower end q + 1 and
    KSWIN's middle at stat sizes 1, wr/3 and wr − 1 — and its end window,
    on rows with a segment of padding, a first segment of padding, fewer
    valid elements than the window and none padded, from a carried
    window."""
    buf, errs, valid = _ring_rows(n * 7 + wr, n, wr)
    ps_plain, _, vcnt, end_plain = tdet._ring_compact(
        torch.from_numpy(buf), torch.from_numpy(errs), torch.from_numpy(valid))
    for row in range(4):
        ps, end = _ring_cluster_model(buf[row], errs[row], valid[row])
        nv = int(vcnt[row, -1])
        q1 = np.arange(1, nv + 1)
        rank = np.nonzero(valid[row])[0] // tdet.CLUSTER_SEGMENT  # each element's CTA
        reads = [wr + q1, q1] + [wr + q1 - r for r in sorted({1, max(1, wr // 3), wr - 1})]
        for k in reads:
            np.testing.assert_array_equal(_bits(ps(k, rank)), _bits(ps_plain[row].numpy()[k]))
        np.testing.assert_array_equal(_bits(end), _bits(end_plain[row].numpy()))


def test_ring_critical_values_are_cached_bit_for_bit():
    """KSWIN's and STEPD's critical values are computed once a parameter
    value (``functools.cache``) and are the JAX package's values, so the
    same float32 bits as before; the launch constants built from them
    too."""
    for kw in (dict(), dict(window_size=20, stat_size=5), dict(alpha=0.01, stat_size=7)):
        jp, tp = jconfig.KSWINParams(**kw), tconfig.KSWINParams(**kw)
        assert tdet._kswin_crit(tp) == jdet._kswin_crit(jp)
        hits = tdet._kswin_crit.cache_info().hits
        assert tdet._kswin_crit(tp) == jdet._kswin_crit(jp)
        assert tdet._kswin_crit.cache_info().hits == hits + 1
        consts = tdet._kswin_consts(tp)
        assert consts[-1] == prefix.f32(jdet._kswin_crit(jp))
        assert _bits(np.float32(consts[-1])) == _bits(np.float32(jdet._kswin_crit(jp)))
    for kw in (dict(), dict(alpha_drift=0.01, alpha_warning=0.1), dict(window_size=5)):
        jp, tp = jconfig.STEPDParams(**kw), tconfig.STEPDParams(**kw)
        for a, ja in ((tp.alpha_drift, jp.alpha_drift), (tp.alpha_warning, jp.alpha_warning)):
            assert tdet._z_crit(float(a)) == jdet._z_crit(float(ja))
            assert tdet._z_crit(float(a)) == tdet._z_crit.__wrapped__(float(a))
        hits = tdet._z_crit.cache_info().hits
        consts = tdet._stepd_consts(tp)
        assert consts == (int(jp.window_size), prefix.f32(1.0 / jp.window_size),
                          prefix.f32(jdet._z_crit(jp.alpha_drift)),
                          prefix.f32(jdet._z_crit(jp.alpha_warning)))
        tdet._stepd_signal(torch.tensor([0]), torch.tensor([0.0]), torch.tensor([0.0]), tp)
        assert tdet._z_crit.cache_info().hits >= hits + 2


def _eddm_probe_row(seed, n=60_000):
    """0/1 errors with one error every 700–1,299 elements: the squared
    distances' prefix passes 2^24 after some 16 errors."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.integers(700, 1300, 200))
    row = np.zeros(n, np.float32)
    row[pos[pos < n]] = 1.0
    return row


@pytest.mark.parametrize("member", ["eddm", "eddm_exact"])
def test_eddm_prefix_past_2_24_matches_jax(member):
    """EDDM's distance sums past 2^24 (ROADMAP C11): three 60,000-element
    rows through the JAX package's ``_eddm_masks`` and the port's — the
    probe row from a fresh state (the JAX package: ``d2_sum`` 61,944,784,
    ``m2s_max`` 1379.99707), a second row from a carried ``d2_sum`` already
    past 2^24, and a row whose errors thicken halfway (it signals). Every
    end-state leaf bit for bit, both masks equal."""
    _, jp, tp = _params(member)
    late = _eddm_probe_row(2)
    late[30_000::97] = 1.0
    errs = np.stack([_eddm_probe_row(0), _eddm_probe_row(1), late])
    valid = np.ones_like(errs, dtype=bool)
    jmasks = jax.jit(jax.vmap(lambda s, e, v: jdet._eddm_masks(s, e, v, jp)))
    fresh = jax.tree.map(lambda x: jnp.stack([x] * 3), jdet.eddm_init())
    first, _, _ = jmasks(fresh, jnp.asarray(errs[:1].repeat(3, 0)), jnp.asarray(valid))
    state = jax.tree.map(lambda f, c: f.at[1].set(c[1]), fresh, first)
    assert float(state.d2_sum[1]) > 2.0**24
    jend, jw, jc = jmasks(state, jnp.asarray(errs), jnp.asarray(valid))
    tend, tw, tc = tdet._eddm_masks(convert.detector_state("eddm", state),
                                    torch.from_numpy(errs), torch.from_numpy(valid), tp)
    _assert_same_state(jend, tend)
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert bool(np.asarray(jc).any())
    if member == "eddm":
        assert float(tend.d2_sum[0]) == 61_944_784.0
        assert float(tend.m2s_max[0]) == float(np.float32(1379.99707))


def test_sqrt_is_correctly_rounded():
    """``prefix.sqrt`` is the correctly rounded float32 root (numpy's and
    XLA's ``jnp.sqrt``) on a million values, and the zoo's bounds built on
    it — HDDM-A's ε and bound, HDDM-W's ε — equal the JAX package's bit for
    bit over long vectors, where ``torch.sqrt``'s vectorised CPU path can
    misround (ROADMAP C12)."""
    x = (np.random.default_rng(0).random(1_000_000) * 100).astype(np.float32)
    got = prefix.sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.sqrt(x)))
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(jax.jit(jnp.sqrt)(x))))
    n = np.arange(1, 200_001, dtype=np.int32)
    n_min = np.maximum(n // 3, 1).astype(np.int32)
    nf = n.astype(np.float32)
    pairs = [
        (jax.jit(lambda a: jdet._hddm_eps(a, 0.001))(nf),
         tdet._hddm_eps(torch.from_numpy(nf), 0.001)),
        (jax.jit(lambda a, m: jdet._hddm_bound(a, m, 0.005))(n, n_min),
         tdet._hddm_bound(torch.from_numpy(n), torch.from_numpy(n_min), 0.005)),
        (jax.jit(lambda v: jdet._hddm_w_eps(v, 0.001))(x[:200_000] / 50),
         tdet._hddm_w_eps(torch.from_numpy(x[:200_000] / 50), prefix.f32(np.log(1 / 0.001)))),
    ]
    for want, have in pairs:
        np.testing.assert_array_equal(_bits(have.numpy()), _bits(np.asarray(want)))
