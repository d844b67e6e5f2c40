"""The port's hand-written CUDA kernels against their plain versions, on the
card. JAX-free, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which pins JAX to the CPU.)
Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu_torch.config import DDM_ROBUST, DDMParams  # noqa: E402
from distributed_drift_detection_tpu_torch.models import classifiers  # noqa: E402
from distributed_drift_detection_tpu_torch.ops import ddm  # noqa: E402

PARAMS = {
    "classic": DDMParams(),
    "robust": DDM_ROBUST,
    "warmup": DDMParams(min_num_instances=60),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (see this module's docstring)")
    return torch.device("cuda")


def _ddm_inputs(seed, p, w, b):
    rng = np.random.default_rng(seed)
    n = w * b
    flip = rng.integers(0, n, p)[:, None]
    rate = np.where(np.arange(n)[None] < flip, rng.uniform(0, 0.1, (p, 1)),
                    rng.uniform(0.3, 0.9, (p, 1)))
    errs = (rng.random((p, n)) < rate).astype(np.float32).reshape(p, w, b)
    valid = rng.random((p, w, b)) < 0.9
    if p > 1:
        valid[1] = False  # an all-padding row
    valid[0, w // 4: w // 2] = False  # whole CTAs of padding at cs = 8
    return errs, valid


# (P, W, B): the main path's shape; cluster sizes 8 (P <= 16) and 1
# (P = 200); cluster sizes that do not divide W (7, 130); W below the
# cluster size (5, 7 < 8); a CTA slice of several 2048-element tiles
# (P = 67: cs = 1, 5200 elements).
K1_SHAPES = [(6, 5, 20), (16, 128, 100), (3, 7, 33), (1, 128, 100),
             (200, 7, 20), (16, 130, 20), (1, 5, 30), (67, 40, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("which", sorted(PARAMS))
def test_ddm_window_kernel_bitwise(dev, which, shape):
    """K1 equals its plain version on the card in every output, the end
    state included, from fresh and carried (inf-minimum) states."""
    params = PARAMS[which]
    p, w, b = shape
    e0, v0 = (torch.from_numpy(a).to(dev) for a in _ddm_inputs(1, p, 1, 40))
    e1, v1 = (torch.from_numpy(a).to(dev) for a in _ddm_inputs(2, p, w, b))
    fresh = ddm.ddm_init((p,), dev)
    carried, _ = ddm.ddm_window_reference(fresh, e0, v0, params)
    if which == "warmup":  # 40 elements < 60: +inf minima with a payload
        assert bool((torch.isinf(carried.ps_min) & torch.isfinite(carried.p_min)).all())
    for state in (fresh, carried):
        before = ddm.ddm_window.launches
        got = ddm.ddm_window(state, e1, v1, params)
        want = ddm.ddm_window_reference(state, e1, v1, params)
        assert ddm.ddm_window.launches == before + 1
        for g, r in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
def test_centroid_predict_err_kernel(dev, idx_dtype):
    """K2 gives predictions and errors equal to its plain version; a row
    whose classes are all absent predicts 0."""
    rng = np.random.default_rng(3)
    p, n, c, f, r = 4, 1000, 12, 9, 500
    protos = rng.normal(size=(c, f)).astype(np.float32) * 3
    ty = rng.integers(0, c, r).astype(np.int32)
    table = (protos[ty] + 0.3 * rng.normal(size=(r, f))).astype(np.float32)
    cent = (protos[None] + 0.1 * rng.normal(size=(p, c, f))).astype(np.float32)
    bias = (-0.5 * (cent.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    bias[rng.random((p, c)) < 0.3] = -np.inf
    bias[0] = -np.inf
    idx = rng.integers(0, r, (p, n))
    args = [torch.from_numpy(a).to(dev) for a in (cent, bias, table, ty)]
    idx_t = torch.from_numpy(idx).to(dev, idx_dtype)
    err, pred = classifiers.centroid_predict_err(*args, idx_t, return_pred=True)
    rerr, rpred = classifiers.centroid_predict_err_reference(*args, idx_t)
    assert torch.equal(pred, rpred) and torch.equal(err, rerr)
    assert int(pred[0].abs().sum()) == 0


def _k2_case(seed, p, n, c, f, r=600):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(c, f)).astype(np.float32) * 3
    ty = rng.integers(0, c, r).astype(np.int32)
    table = (protos[ty] + 0.3 * rng.normal(size=(r, f))).astype(np.float32)
    cent = (protos[None] + 0.1 * rng.normal(size=(p, c, f))).astype(np.float32)
    bias = (-0.5 * (cent.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    bias[rng.random((p, c)) < 0.3] = -np.inf
    bias[0] = -np.inf
    idx = rng.integers(0, r, (p, n))
    return cent, bias, table, ty, idx


@pytest.mark.cuda
@pytest.mark.parametrize("f, c", [(21, 40), (27, 40), (27, 64), (32, 40), (37, 64),
                                  (3, 5), (256, 64)])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
def test_centroid_predict_err_kernel_widths(dev, f, c, idx_dtype):
    """K2's register path (F up to 32, in float4 steps with a ragged last
    step), its generic path (F = 37, and F = 256 with 66 KB of centroids
    above the default 48 KB), C = 40 and 64: equal to its plain version,
    from the padded row table and from the unpadded one."""
    cent, bias, table, ty, idx = _k2_case(f * 100 + c, 3, 1100, c, f)
    args = [torch.from_numpy(a).to(dev) for a in (cent, bias, table, ty)]
    idx_t = torch.from_numpy(idx).to(dev, idx_dtype)
    rerr, rpred = classifiers.centroid_predict_err_reference(*args, idx_t)
    padded = classifiers.pad_row_table(args[2])
    assert padded.shape[1] % 4 == 0
    for T in (padded, args[2]):
        err, pred = classifiers.centroid_predict_err(
            args[0], args[1], T, args[3], idx_t, return_pred=True)
        assert torch.equal(pred, rpred) and torch.equal(err, rerr)
    assert int(pred[0].abs().sum()) == 0  # every class absent: class 0


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
def test_centroid_predict_err_kernel_near_ties(dev, idx_dtype):
    """The near-tie rows of tests/test_torch_models.py: an exact tie goes
    to the first class, and 5e-5 either side of a near tie is resolved."""
    c, f = 5, 6
    cent = np.zeros((c, f), np.float32)
    cent[1] = cent[3] = 1.0
    cent[2] = cent[4] = 2.0
    cent[4, 0] = 2.001
    bias = (-0.5 * (cent * cent).sum(1)).astype(np.float32)
    bias[0] = -np.inf
    rows = np.stack([np.full(f, 1.0), np.r_[2.05, np.full(f - 1, 2.0)],
                     np.r_[1.95, np.full(f - 1, 2.0)]]).astype(np.float32)
    want = np.array([1, 4, 2], np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (cent[None], bias[None], rows, want)]
    idx = torch.arange(3, device=dev, dtype=idx_dtype)[None]
    err, pred = classifiers.centroid_predict_err(*args, idx, return_pred=True)
    assert pred.cpu().numpy()[0].tolist() == want.tolist()
    assert int(err.sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("f", [21, 37])
def test_centroid_predict_err_kernel_class_chunks(dev, f):
    """C = 3,000 classes, more than shared memory holds at once (2,058 at
    F = 21 on the register path; 1,417 at F = 37 on the generic one), run
    in chunks of classes in class order: predictions equal to the plain
    version's off the near ties (the two best float64 scores within
    1e-4·(1 + |top|); the kernel's dot chain and torch.bmm sum in other
    orders), errors ``pred != label``."""
    c = 3000
    cent, bias, table, ty, idx = _k2_case(c + f, 3, 1100, c, f)
    args = [torch.from_numpy(a).to(dev) for a in (cent, bias, table, ty)]
    idx_t = torch.from_numpy(idx).to(dev, torch.int32)
    before = classifiers.centroid_predict_err.launches
    err, pred = classifiers.centroid_predict_err(*args, idx_t, return_pred=True)
    assert classifiers.centroid_predict_err.launches == before + 1
    _, rpred = classifiers.centroid_predict_err_reference(*args, idx_t)
    scores = (torch.from_numpy(table[idx]).double() @ torch.from_numpy(cent).double()
              .transpose(1, 2) + torch.from_numpy(bias).double()[:, None])
    top2 = scores.topk(2, -1).values
    tie = ((top2[..., 0] - top2[..., 1]) <= 1e-4 * (1 + top2[..., 0].abs())).to(dev)
    assert torch.equal(pred[~tie], rpred[~tie])
    assert torch.equal(err, (pred != args[3][idx_t.long()]).float())
    assert int(tie.sum()) < 10


# (P, N, C, F): wide rows — F = 1,600 and 2,048 take the generic path
# with the classes in chunks (28 of them at F = 2,048); F = 60,000 is too
# wide for one class in shared memory and takes its features in chunks
K2_WIDE = [(2, 300, 40, 1600), (2, 300, 40, 2048), (2, 70, 5, 60000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K2_WIDE)
def test_centroid_predict_err_kernel_wide_rows(dev, shape):
    """K2 at any F: predictions equal to the plain version's off the near
    ties (the two best float64 scores within 1e-4·(1 + |top|)), errors
    ``pred != label``, one launch."""
    p, n, c, f = shape
    cent, bias, table, ty, idx = _k2_case(f, p, n, c, f, r=64)
    args = [torch.from_numpy(a).to(dev) for a in (cent, bias, table, ty)]
    idx_t = torch.from_numpy(idx).to(dev, torch.int32)
    before = classifiers.centroid_predict_err.launches
    err, pred = classifiers.centroid_predict_err(*args, idx_t, return_pred=True)
    assert classifiers.centroid_predict_err.launches == before + 1
    _, rpred = classifiers.centroid_predict_err_reference(*args, idx_t)
    scores = (torch.from_numpy(table[idx]).double() @ torch.from_numpy(cent).double()
              .transpose(1, 2) + torch.from_numpy(bias).double()[:, None])
    top2 = scores.topk(2, -1).values
    tie = ((top2[..., 0] - top2[..., 1]) <= 1e-4 * (1 + top2[..., 0].abs())).to(dev)
    assert torch.equal(pred[~tie], rpred[~tie])
    assert torch.equal(err, (pred != args[3][idx_t.long()]).float())


# --------------------------------------------------------------------------
# K7, the centroid fit
# --------------------------------------------------------------------------

# (P, B, F, C): the main path's shape; per_batch 256 and 1000 (four tiles
# of 256 rows); C·(F + 1) below one warp; 16,448 (class, feature) pairs,
# more than a block's threads, whose shared memory halves the row tile.
K7_SHAPES = [(16, 100, 21, 40), (4, 256, 27, 5), (3, 1000, 21, 40), (2, 7, 3, 4),
             (1, 300, 256, 64)]


def _k7_inputs(seed, p, b, f, c):
    """Rows near ``c`` prototypes, {0, 1} weights, one class absent in
    every partition and a few labels outside [0, C) (no class)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(c, f)).astype(np.float32) * 3
    y = rng.integers(0, max(c - 1, 1), (p, b)).astype(np.int32)
    X = (protos[y] + 0.5 * rng.normal(size=(p, b, f))).astype(np.float32)
    w = (rng.random((p, b)) < 0.9).astype(np.float32)
    y[rng.random((p, b)) < 0.02] = c
    return X, y, w


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K7_SHAPES)
def test_centroid_fit_kernel_bitwise(dev, shape):
    """K7 equals its plain version bit for bit — on the card and on the
    CPU — centroids, biases and the -inf of absent classes."""
    p, b, f, c = shape
    host = [torch.from_numpy(a) for a in _k7_inputs(sum(shape), p, b, f, c)]
    before = classifiers.centroid_fit.launches
    got = classifiers.centroid_fit(*(t.to(dev) for t in host), c)
    assert classifiers.centroid_fit.launches == before + 1
    on_card = classifiers.centroid_fit_reference(*(t.to(dev) for t in host), c)
    on_cpu = classifiers.centroid_fit_reference(*host, c)
    for g, r, h in zip(got, on_card, on_cpu):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), h.view(torch.int32))
    assert bool(torch.isinf(got.bias[:, -1]).all())


# K7's label layouts, (P, B, F, C) each: every row of one class (a chain of
# B), C = 1, B = 1 (XLA's product, zero products keep their sign), three
# row tiles of 1024 (B = 2049, above 48 KB of shared memory, partition 1's
# rows off a 16-byte boundary), every label outside [0, C), all weights 0.
K7_LAYOUTS = {
    "one_class": (4, 100, 21, 40),
    "one_class_c1": (3, 100, 21, 1),
    "per_batch_1": (16, 1, 21, 40),
    "per_batch_2049": (2, 2049, 21, 40),
    "no_class": (4, 100, 21, 40),
    "weights_0": (4, 100, 21, 40),
}


def _k7_layout(name):
    """``_k7_inputs`` at the layout's shape, then its labels or weights."""
    p, b, f, c = K7_LAYOUTS[name]
    X, y, w = _k7_inputs(sorted(K7_LAYOUTS).index(name), p, b, f, c)
    if name == "one_class":
        y[:] = 7
    elif name == "no_class":
        y[:] = np.where(np.arange(b) % 2 == 0, c, -3)
    elif name == "weights_0":
        w[:] = 0.0
    return X, y, w, c


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(K7_LAYOUTS))
def test_centroid_fit_kernel_label_layouts(dev, layout):
    """K7 equals its plain version bit for bit on the card and on the CPU
    for each label layout of its sorted row list."""
    X, y, w, c = _k7_layout(layout)
    host = [torch.from_numpy(a) for a in (X, y, w)]
    before = classifiers.centroid_fit.launches
    got = classifiers.centroid_fit(*(t.to(dev) for t in host), c)
    assert classifiers.centroid_fit.launches == before + 1
    on_card = classifiers.centroid_fit_reference(*(t.to(dev) for t in host), c)
    on_cpu = classifiers.centroid_fit_reference(*host, c)
    for g, r, h in zip(got, on_card, on_cpu):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), h.view(torch.int32))
    if layout in ("no_class", "weights_0"):
        assert bool(torch.isinf(got.bias).all())
    else:
        assert bool(torch.isfinite(got.bias).any())


# (P, B, F, C): C = 3,000 classes, more than shared memory holds at once
# (2,490 at F = 21), in chunks of classes: at one row tile of 100 rows, and
# of 1,000 (more classes present, smaller chunks)
K7_CLASS_CHUNKS = [(3, 100, 21, 3000), (2, 1000, 21, 3000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K7_CLASS_CHUNKS)
def test_centroid_fit_kernel_class_chunks(dev, shape):
    """K7 with its classes in chunks equals its plain version bit for bit
    on the card and on the CPU (each class's chain is unchanged)."""
    p, b, f, c = shape
    host = [torch.from_numpy(a) for a in _k7_inputs(sum(shape), p, b, f, c)]
    before = classifiers.centroid_fit.launches
    got = classifiers.centroid_fit(*(t.to(dev) for t in host), c)
    assert classifiers.centroid_fit.launches == before + 1
    on_card = classifiers.centroid_fit_reference(*(t.to(dev) for t in host), c)
    on_cpu = classifiers.centroid_fit_reference(*host, c)
    for g, r, h in zip(got, on_card, on_cpu):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), h.view(torch.int32))
    assert bool(torch.isfinite(got.bias).any()) and bool(torch.isinf(got.bias[:, -1]).all())


# (P, B, F, C): rows too wide for shared memory at one class and one row
# (F above 1,570), their features in chunks: F = 1,600 and 2,048 at the
# main path's batch, B = 1 (XLA's product), and C = 3,000 (classes halved
# until a chunk of features fits)
K7_WIDE = [(2, 100, 1600, 40), (2, 100, 2048, 40), (3, 1, 2048, 40), (1, 64, 1700, 3000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K7_WIDE)
def test_centroid_fit_kernel_feature_chunks(dev, shape):
    """K7 with its features in chunks equals its plain version bit for bit
    on the card and on the CPU (each sum keeps its row chain; the bias
    chain is carried across chunks in feature order)."""
    p, b, f, c = shape
    host = [torch.from_numpy(a) for a in _k7_inputs(sum(shape), p, b, f, c)]
    before = classifiers.centroid_fit.launches
    got = classifiers.centroid_fit(*(t.to(dev) for t in host), c)
    assert classifiers.centroid_fit.launches == before + 1
    on_card = classifiers.centroid_fit_reference(*(t.to(dev) for t in host), c)
    on_cpu = classifiers.centroid_fit_reference(*host, c)
    for g, r, h in zip(got, on_card, on_cpu):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), h.view(torch.int32))


# --------------------------------------------------------------------------
# the zoo kernels K5-ph, K5-eddm, K5-hddm, K5-hddm_w, K5-kswin, K5-stepd,
# K5-adwin
# --------------------------------------------------------------------------

from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch.ops import adwin as tadwin  # noqa: E402
from distributed_drift_detection_tpu_torch.ops import detectors as tdet  # noqa: E402


def zoo_inputs(seed, p, w, b, first_change=False):
    """DDM's inputs, plus a constant all-zero stretch in partition 2 (HDDM-W
    key ties once v converges) and, with ``first_change``, an error in
    every row's first element."""
    errs, valid = _ddm_inputs(seed, p, w, b)
    if p > 2:
        errs[2].reshape(-1)[: (w * b) // 2] = 0.0
    if first_change:
        errs[:, 0, 0] = 1.0
        valid[:, 0, 0] = True
    return errs, valid


# (P, W, B): the main path's shape; P = 1 and 17; W below and above a few
# CTA threads' chunk; N = 26,000 and 16,000 (the scan levels then exceed
# shared memory and go to the global scratch).
ZOO_SHAPES = [(16, 128, 100), (3, 7, 33), (1, 5, 30), (17, 4, 50), (2, 200, 130), (1, 160, 100)]
ZOO = {
    "ph": (tdet.ph_window, tdet.ph_window_reference, tdet.ph_init, [
        tconfig.PHParams(min_num_instances=5, threshold=3.0),
        tconfig.PHParams(min_num_instances=5, threshold=3.0, alpha=0.9),
        tconfig.PHParams(min_num_instances=3, delta=0.0, threshold=0.5, alpha=0.0),
    ]),
    "hddm_w": (tdet.hddm_w_window, tdet.hddm_w_window_reference, tdet.hddm_w_init, [
        tconfig.HDDMWParams(), tconfig.HDDMWParams(lam=0.3),
    ]),
    "adwin": (tadwin.adwin_window, tadwin.adwin_window_reference, None, [
        tconfig.ADWINParams(), tconfig.ADWINParams(clock=1),
        tconfig.ADWINParams(max_levels=3, clock=4),
    ]),
    "eddm": (tdet.eddm_window, tdet.eddm_window_reference, tdet.eddm_init, [
        tconfig.EDDMParams(), tconfig.EDDMParams(paper_exact=True, min_num_errors=5),
    ]),
    "hddm": (tdet.hddm_window, tdet.hddm_window_reference, tdet.hddm_init, [
        tconfig.HDDMParams(), tconfig.HDDMParams(drift_confidence=0.01),
    ]),
    "kswin": (tdet.kswin_window, tdet.kswin_window_reference, None, [
        tconfig.KSWINParams(), tconfig.KSWINParams(window_size=20, stat_size=5),
    ]),
    "stepd": (tdet.stepd_window, tdet.stepd_window_reference, None, [
        tconfig.STEPDParams(), tconfig.STEPDParams(window_size=5),
    ]),
}


def _zoo_init(name, params, p, dev):
    if name == "adwin":
        return tadwin.adwin_init(params, (p,), dev)
    if name in ("kswin", "stepd"):
        return getattr(tdet, f"{name}_init")(params, (p,), dev)
    return ZOO[name][2]((p,), dev)


def _same(got, want):
    for g, r in zip(got[0] + got[1], want[0] + want[1]):
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ZOO_SHAPES)
@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_window_kernels_bitwise(dev, name, shape):
    """Each zoo kernel equals its plain version on the card in every
    output — float leaves bit for bit, ADWIN's int32 state exactly — from
    a fresh state (empty prefixes), from a carried one, with all-padding
    rows, an error in the first element, HDDM-W key ties, PH at alpha = 0
    with padding, ADWIN at clock = 1 and forgetting at capacity, EDDM's
    paper_exact mode, KSWIN's and STEPD's smaller windows."""
    window, reference, _, cases = ZOO[name]
    p, w, b = shape
    for k, params in enumerate(cases):
        if getattr(params, "clock", 32) == 1 and w * b > 2000:
            continue  # ADWIN's plain version flushes per element there
        for first in (False, True):
            e0, v0 = (torch.from_numpy(a).to(dev) for a in zoo_inputs(10 + k, p, 3, 40))
            e1, v1 = (torch.from_numpy(a).to(dev)
                      for a in zoo_inputs(20 + k, p, w, b, first_change=first))
            fresh = _zoo_init(name, params, p, dev)
            carried, _ = reference(fresh, e0, v0, params)
            for state in (fresh, carried):
                launches = window.launches
                got = window(state, e1, v1, params)
                want = reference(state, e1, v1, params)
                assert window.launches == launches + 1
                _same(got, want)


# Rows of the ring-buffer members (P, W, B) shorter than their window
# (``window_size`` 100 and 30, 20 and 5): 7 to 60 elements, every third row
# all padding; and the global-scratch paths of the prefix row (K5-kswin,
# K5-stepd) and of K5-eddm's sums' tree: a row of 60,000 elements, and a
# W of 28,000 batches of one, whose first flags leave shared memory too
# small for the tree.
RING_SHORT = [(3, 1, 7), (6, 2, 10), (4, 3, 20), (3, 60, 1)]
SCRATCH_PATHS = [(1, 600, 100), (1, 28000, 1)]


def _short_inputs(seed, p, w, b):
    errs, valid = zoo_inputs(seed, p, w, b)
    valid[::3] = False
    return errs, valid


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RING_SHORT)
@pytest.mark.parametrize("name", ["kswin", "stepd"])
def test_ring_kernels_short_and_padded_rows(dev, name, shape):
    """K5-kswin and K5-stepd equal their plain versions bit for bit on rows
    with fewer valid elements than the ring buffer holds and on all-padding
    rows, from a fresh buffer, a carried one and one carried through three
    short windows (the buffer partly old, partly new)."""
    window, reference, _, cases = ZOO[name]
    p, w, b = shape
    for k, params in enumerate(cases):
        state = _zoo_init(name, params, p, dev)
        e0, v0 = (torch.from_numpy(a).to(dev) for a in zoo_inputs(60 + k, p, 3, 40))
        carried, _ = reference(state, e0, v0, params)
        for start in (state, carried):
            s = start
            for step in range(3):
                e1, v1 = (torch.from_numpy(a).to(dev)
                          for a in _short_inputs(70 + 10 * k + step, p, w, b))
                launches = window.launches
                got = window(s, e1, v1, params)
                want = reference(s, e1, v1, params)
                assert window.launches == launches + 1
                _same(got, want)
                s = want[0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCRATCH_PATHS)
@pytest.mark.parametrize("name", ["eddm", "kswin", "stepd"])
def test_zoo_kernels_global_scratch_paths(dev, name, shape):
    """K5-eddm, K5-kswin and K5-stepd on rows whose sums' tree or prefix row
    does not fit in shared memory (the wrapper's global scratch), from fresh
    and carried states, bit for bit their plain versions."""
    window, reference, _, cases = ZOO[name]
    p, w, b = shape
    for k, params in enumerate(cases):
        e0, v0 = (torch.from_numpy(a).to(dev) for a in zoo_inputs(80 + k, p, 3, 40))
        e1, v1 = (torch.from_numpy(a).to(dev) for a in zoo_inputs(90 + k, p, w, b, True))
        fresh = _zoo_init(name, params, p, dev)
        carried, _ = reference(fresh, e0, v0, params)
        for state in (fresh, carried):
            _same(window(state, e1, v1, params), reference(state, e1, v1, params))


def _eddm_probe_rows(p, n=60_000):
    rows = []
    for seed in range(p):
        pos = np.cumsum(np.random.default_rng(seed).integers(700, 1300, 200))
        row = np.zeros(n, np.float32)
        row[pos[pos < n]] = 1.0
        rows.append(row)
    return np.stack(rows)


@pytest.mark.cuda
def test_eddm_kernel_sums_past_2_24(dev):
    """K5-eddm's sums of squared distances past 2^24 (ROADMAP C11): rows of
    60,000 elements with an error every 700–1,299, from a fresh state and
    from the end state of the first pass (``d2_sum`` past 2^24), in windows
    of [3, 600, 100] and [3, 120, 500] (the one-CTA path), and the rows'
    first 16,000 elements as [3, 160, 100] (the cluster path, 8 CTAs), bit
    for bit the plain version."""
    errs = torch.from_numpy(_eddm_probe_rows(3)).to(dev)
    valid = torch.ones_like(errs, dtype=torch.bool)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tdet.cluster_ctas(3, 60_000, sms) == 0 and tdet.cluster_ctas(3, 16_000, sms) == 8
    for params in ZOO["eddm"][3]:
        for w, b in ((600, 100), (120, 500)):
            e, v = errs.view(3, w, b), valid.view(3, w, b)
            fresh = tdet.eddm_init((3,), dev)
            carried, _ = tdet.eddm_window_reference(fresh, e, v, params)
            assert float(carried.d2_sum.min()) > 2.0**24
            for state in (fresh, carried):
                _same(tdet.eddm_window(state, e, v, params),
                      tdet.eddm_window_reference(state, e, v, params))
        e = errs[:, :16_000].reshape(3, 160, 100).contiguous()
        v = torch.ones_like(e, dtype=torch.bool)
        for state in (tdet.eddm_init((3,), dev), carried):
            _same(tdet.eddm_window(state, e, v, params),
                  tdet.eddm_window_reference(state, e, v, params))


# The paths of K5-ph, K5-hddm_w, K5-eddm, K5-hddm, K5-kswin and K5-stepd
# (one shape rule, ``cluster_ctas``; ``ring_ctas`` for the last two, the
# same at their windows here), (P, W, B) and whether a row takes the
# cluster path:
# ragged rows of 21 elements and of 12,800 (7 CTAs, the last a quarter full;
# row 0's batches 32-63 padding, so CTA 2's whole segment) at P = 1, 16 and
# 80 (clusters of 8, 8 and 1 CTAs at most: the longer rows at P = 80 take
# the one-CTA path); a full cluster of 8 (16,384 elements) and one element
# more (one CTA); batches that straddle CTAs (B = 129), one batch over every
# CTA (B = 16,384) and batches of one element; last segments of 10
# elements (shorter than EDDM's blocks of 16) and of 17 (not a multiple of
# 16), and rows of exactly 3 segments.
CLUSTER_PATHS = {
    "p1_ragged_21": ((1, 3, 7), True), "p16_ragged_21": ((16, 3, 7), True),
    "p80_ragged_21": ((80, 3, 7), True), "p1_12800": ((1, 128, 100), True),
    "p16_12800": ((16, 128, 100), True), "p80_12800": ((80, 128, 100), False),
    "full_cluster": ((2, 128, 128), True), "one_more": ((2, 16385, 1), False),
    "straddling_batches": ((3, 127, 129), True), "one_batch": ((2, 1, 16384), True),
    "batches_of_one": ((2, 4000, 1), True),
    "last_segment_10": ((2, 2, 1029), True), "last_segment_17": ((3, 101, 61), True),
    "three_whole_segments": ((2, 48, 128), True),
}


def _zoo_ctas(name, params, p, n, sms):
    """The CTAs a row of zoo kernel ``name``'s launch (0: one CTA)."""
    if name in ("kswin", "stepd"):
        return tdet.ring_ctas(p, n, params.window_size, sms)
    return tdet.cluster_ctas(p, n, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CLUSTER_PATHS))
@pytest.mark.parametrize("name", ["eddm", "hddm", "hddm_w", "kswin", "ph", "stepd"])
def test_cluster_kernel_paths(dev, name, case):
    """K5-ph, K5-hddm_w, K5-eddm, K5-hddm, K5-kswin and K5-stepd equal their
    plain versions bit for bit on their cluster paths (clusters of 1 to 8
    CTAs, state in registers) and their one-CTA paths, from fresh and
    carried states, with an error in each row's first element, HDDM-W key
    ties, every Page–Hinkley parameter set (alpha = 0 among them), EDDM's
    paper_exact mode and both window sizes of KSWIN and STEPD; each case
    checks the path it names."""
    window, reference, _, cases = ZOO[name]
    (p, w, b), cluster = CLUSTER_PATHS[case]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for k, params in enumerate(cases):
        assert (_zoo_ctas(name, params, p, w * b, sms) > 0) == cluster
        e0, v0 = (torch.from_numpy(a).to(dev) for a in zoo_inputs(30 + k, p, 3, 40))
        e1, v1 = (torch.from_numpy(a).to(dev)
                  for a in zoo_inputs(40 + k, p, w, b, first_change=True))
        fresh = _zoo_init(name, params, p, dev)
        carried, _ = reference(fresh, e0, v0, params)
        for state in (fresh, carried):
            launches = window.launches
            got = window(state, e1, v1, params)
            want = reference(state, e1, v1, params)
            assert window.launches == launches + 1
            _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 60, 1), (3, 3, 20), (4, 3, 7), (3, 101, 61)])
@pytest.mark.parametrize("name", ["eddm", "hddm", "hddm_w", "kswin", "ph", "stepd"])
def test_cluster_kernels_ragged_rows_before_live_ones(dev, name, shape):
    """All-live rows whose length is not a multiple of 8, each followed in
    memory by live elements: a thread holding the last 1-7 elements of an
    aligned row loads them one by one and counts none of the next row's
    (cluster_tree.cuh ``load_elements``; a miscompiled bound there once
    counted them in K5-kswin and K5-stepd). Bit for bit the plain version,
    from fresh and carried states."""
    window, reference, _, cases = ZOO[name]
    p, w, b = shape
    rng = np.random.default_rng(120)
    e1 = torch.from_numpy((rng.random((p, w, b)) < 0.4).astype(np.float32)).to(dev)
    v1 = torch.ones_like(e1, dtype=torch.bool)
    for k, params in enumerate(cases):
        e0, v0 = (torch.from_numpy(a).to(dev) for a in zoo_inputs(130 + k, p, 3, 40))
        fresh = _zoo_init(name, params, p, dev)
        carried, _ = reference(fresh, e0, v0, params)
        for state in (fresh, carried):
            _same(window(state, e1, v1, params), reference(state, e1, v1, params))


def _ring_lookback_rows(seed, p, n, wr):
    """Rows of ``n`` elements for the ring members' look-backs across CTAs,
    error rate 0.05 then 0.6 from a third of the row (so windows fire): row
    0's second segment all padding (the third's first windows reach two
    CTAs back), row 1's first segment all padding (later windows reach into
    the carried window), row 2 with ``wr // 2`` valid elements (fewer than
    the window: the next window part old, part new), the rest all valid."""
    rng = np.random.default_rng(seed)
    seg = tdet.CLUSTER_SEGMENT
    rate = np.where(np.arange(n) < n // 3, 0.05, 0.6)
    errs = (rng.random((p, n)) < rate).astype(np.float32)
    valid = np.ones((p, n), bool)
    valid[0, seg:2 * seg] = False
    valid[1, :seg] = False
    valid[2] = False
    valid[2, rng.choice(n, min(n, max(1, wr // 2)), replace=False)] = True
    return errs, valid


# The ring members' look-backs across CTAs on the cluster path: the
# parameters (KSWIN's windows of 100 and 30, STEPD's of 30; windows longer
# than a segment, 2,500 with KSWIN's stat_size 700, reaching into several
# CTAs; STEPD's t >= 2w gate crossed in CTA 2 at window 2,500 and in CTA 1
# at 1,500, from a fresh state), on rows of 7 CTAs and of a full cluster
# of 8.
RING_LOOKBACKS = {
    "kswin": ((4, 128, 100), [tconfig.KSWINParams(), tconfig.KSWINParams(window_size=30,
                                                                         stat_size=10),
                              tconfig.KSWINParams(window_size=2500, stat_size=700)]),
    "stepd": ((4, 128, 100), [tconfig.STEPDParams(), tconfig.STEPDParams(window_size=2500),
                              tconfig.STEPDParams(window_size=1500)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 128, 100), (4, 128, 128)])
@pytest.mark.parametrize("name", ["kswin", "stepd"])
def test_ring_cluster_lookbacks_across_ctas(dev, name, shape):
    """K5-kswin and K5-stepd on their cluster paths, bit for bit their plain
    versions in every output, where windows reach back across CTAs: over a
    whole segment of padding, into several CTAs (windows longer than a
    segment), into the carried window from a row whose first segment is
    padding, with fewer valid elements than the window (the next window
    part old, part new) and with STEPD's t >= 2·w gate crossed in a later
    CTA — from a fresh state, a carried one and one carried through a
    whole row."""
    window, reference = ZOO[name][:2]
    p, w, b = shape
    n = w * b
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for k, params in enumerate(RING_LOOKBACKS[name][1]):
        assert tdet.ring_ctas(p, n, params.window_size, sms) == -(-n // 2048)
        e1, v1 = (torch.from_numpy(a.reshape(p, w, b)).to(dev)
                  for a in _ring_lookback_rows(100 + k, p, n, params.window_size))
        e0, v0 = (torch.from_numpy(a).to(dev) for a in zoo_inputs(110 + k, p, 3, 40))
        fresh = _zoo_init(name, params, p, dev)
        carried, _ = reference(fresh, e0, v0, params)
        full = torch.ones_like(v1)
        long_carried, _ = reference(fresh, e1, full, params)
        if name == "stepd" and params.window_size > 100:
            # from a fresh state the all-valid row 3 opens its gate at t = 2w
            # (element 2w - 1), past CTA 0, and fires from there on
            fc = reference(fresh, e1, v1, params)[1].first_change[3]
            hit = torch.nonzero(fc >= 0)
            assert hit.numel() > 0
            t_first = int(hit[0, 0]) * b + int(fc[hit[0, 0]]) + 1
            assert t_first >= 2 * params.window_size > 2048
        for state in (fresh, carried, long_carried):
            launches = window.launches
            got = window(state, e1, v1, params)
            want = reference(state, e1, v1, params)
            assert window.launches == launches + 1
            _same(got, want)


def _late_errors(seed, p, n, starts):
    """All-live rows of ``n`` elements whose first error is at ``starts[i]``
    (errors at rate 0.2 from there on)."""
    rng = np.random.default_rng(seed)
    errs = (rng.random((p, n)) < 0.2).astype(np.float32)
    for i, start in enumerate(starts):
        errs[i, :start] = 0.0
        errs[i, start] = 1.0
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["p16_12800", "full_cluster", "p80_12800"])
def test_eddm_kernel_first_error_in_a_later_cta(dev, case):
    """EDDM's first error of a row in a later CTA than the first — the first
    element of CTA 1, inside CTA 2, the row's last element, none at all —
    from a fresh state and from a carried one with no error (count > 0,
    ``last_err_t`` 0), in both modes: under ``paper_exact`` that error does
    not contribute, wherever it lies. Bit for bit the plain version on both
    paths."""
    (p, w, b), cluster = CLUSTER_PATHS[case]
    n = w * b
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (tdet.cluster_ctas(p, n, sms) > 0) == cluster
    starts = [2048, 5000, n - 1][:p] + [n - 1] * max(0, p - 3)
    errs = _late_errors(60, p, n, starts)
    if p > 3:
        errs[3] = 0.0  # no error in the row
    e1 = torch.from_numpy(errs.reshape(p, w, b)).to(dev)
    v1 = torch.ones_like(e1, dtype=torch.bool)
    quiet = torch.zeros((p, 3, 40), dtype=torch.float32, device=dev)
    for params in ZOO["eddm"][3]:
        fresh = tdet.eddm_init((p,), dev)
        carried, _ = tdet.eddm_window_reference(fresh, quiet, torch.ones_like(
            quiet, dtype=torch.bool), params)
        assert bool((carried.count == 120).all()) and bool((carried.last_err_t == 0).all())
        for state in (fresh, carried):
            _same(tdet.eddm_window(state, e1, v1, params),
                  tdet.eddm_window_reference(state, e1, v1, params))


def _hddm_tie_count(j, confidence, start):
    """A carried count c0 from ``start`` on at which HDDM-A's keys with no
    error, ε(n) at n = c0 + j and c0 + j + 1 (elements j - 1 and j of an
    all-live, error-free row), are equal in float32."""
    n = torch.arange(start + j, start + j + 4096, dtype=torch.int32)
    key = tdet._hddm_eps(n.float(), confidence)
    tie = torch.nonzero(key[:-1] == key[1:])[0, 0]
    return int(n[tie]) - j


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2049, 4097, 12289])
def test_hddm_kernel_key_ties_straddle_segments(dev, n):
    """HDDM-A's running minimum takes the later of equal keys: error-free
    rows carried past 20,000,000 elements (each key ε(n), equal in float32
    for neighbouring n), so that the last two elements — one each side of
    a CTA boundary at 2048, 4096 or 12,288 — tie, and the stored cut is the
    later one's count. Bit for bit the plain version, from a state with no
    cut and from one with a cut."""
    params = ZOO["hddm"][3][0]
    counts = [_hddm_tie_count(n - 1, params.drift_confidence, start)
              for start in (20_000_000, 30_000_000)]
    p = len(counts)
    e1 = torch.zeros((p, 1, n), dtype=torch.float32, device=dev)
    v1 = torch.ones_like(e1, dtype=torch.bool)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tdet.cluster_ctas(p, n, sms) == -(-n // 2048)
    count = torch.tensor(counts, dtype=torch.int32, device=dev)
    zero_f = torch.zeros(p, dtype=torch.float32, device=dev)
    no_cut = tdet.HDDMState(count, zero_f, torch.zeros_like(count), zero_f)
    cut = tdet.HDDMState(count, zero_f, count // 2, zero_f)
    end, _ = tdet.hddm_window_reference(no_cut, e1, v1, params)
    assert bool((end.n_min == count + n).all())  # the later of the tie
    for state in (no_cut, cut):
        _same(tdet.hddm_window(state, e1, v1, params),
              tdet.hddm_window_reference(state, e1, v1, params))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["p16_12800", "straddling_batches", "p80_12800"])
def test_ph_kernel_flushed_alpha_power(dev, case):
    """All-live rows at alpha = 0.5: the running product alpha^k flushes to
    0 inside a CTA's segment (after some hundreds of elements), on both of
    K5-ph's paths, bit for bit from fresh and carried states."""
    (p, w, b), _ = CLUSTER_PATHS[case]
    params = tconfig.PHParams(min_num_instances=5, threshold=3.0, alpha=0.5)
    rng = np.random.default_rng(50)
    e1 = torch.from_numpy((rng.random((p, w, b)) < 0.3).astype(np.float32)).to(dev)
    v1 = torch.ones_like(e1, dtype=torch.bool)
    e0, v0 = (torch.from_numpy(a).to(dev) for a in zoo_inputs(51, p, 3, 40))
    fresh = tdet.ph_init((p,), dev)
    carried, _ = tdet.ph_window_reference(fresh, e0, v0, params)
    for state in (fresh, carried):
        _same(tdet.ph_window(state, e1, v1, params),
              tdet.ph_window_reference(state, e1, v1, params))


@pytest.mark.cuda
def test_adwin_kernel_forgets_at_capacity(dev):
    """A drift-free stream long enough that max_levels = 3 forgets: the
    kernel's window lags t exactly as the plain version's."""
    params = tconfig.ADWINParams(max_levels=3, clock=4)
    rng = np.random.default_rng(11)
    errs = torch.from_numpy((rng.random((2, 9, 100)) < 0.2).astype(np.float32)).to(dev)
    valid = torch.ones_like(errs, dtype=torch.bool)
    state = tadwin.adwin_init(params, (2,), dev)
    got = tadwin.adwin_window(state, errs, valid, params)
    want = tadwin.adwin_window_reference(state, errs, valid, params)
    assert bool((want[0].n < want[0].t).all())
    _same(got, want)


def _adwin_late_drift(seed, p, n, flip=0.8):
    """All-valid 0/1 rows: error rate 0.05, then 0.95 from ``flip`` of the row."""
    rng = np.random.default_rng(seed)
    rate = np.where(np.arange(n)[None] < int(flip * n), 0.05, 0.95)
    return (rng.random((p, n)) < rate).astype(np.float32), np.ones((p, n), bool)


# K5-adwin's paths: (params, [P, W, B]).
ADWIN_PATHS = {
    # slots in registers (C = 8), > 32 occupied boundaries: lanes test two
    "registers_over_32_boundaries": (tconfig.ADWINParams(max_buckets=7, max_levels=8, clock=2),
                                     (2, 20, 100)),
    # C = 13 > 8: the shared-memory histogram, > 32 boundaries
    "shared_histogram": (tconfig.ADWINParams(max_buckets=12, max_levels=8, clock=2),
                         (2, 20, 100)),
    # fewer than `clock` valid elements: no flush
    "no_flush": (tconfig.ADWINParams(), (2, 1, 31)),
    # the chunk tables of 17,000 and 6,000 chunks do not fit beside the
    # ring (registers) or an 8 x 2001 histogram (shared): global scratch
    "global_chunk_table_registers": (tconfig.ADWINParams(max_buckets=7, max_levels=28, clock=1),
                                     (1, 170, 100)),
    "global_chunk_table_shared": (tconfig.ADWINParams(max_buckets=2000, max_levels=8, clock=1),
                                  (2, 60, 100)),
    # the top level overflows mid-window: the ln n table, then ln n in place
    "forgets_mid_window": (tconfig.ADWINParams(max_levels=3, clock=4), (2, 9, 100)),
}


def _adwin_smem_bytes(params, w, b, table):
    """K5-adwin's dynamic shared memory (csrc/adwin_window.cu's launcher):
    the per-batch firsts, then with slots in registers the flush ring
    (2 x 32 records of 292 ints) and 15 warps' boundary arrays, or with
    slots in shared memory one boundary array and the histogram; then,
    with ``table``, the chunk table."""
    lc = params.max_levels * (params.max_buckets + 1)
    firsts = (2 * w * 4 + 15) // 16 * 16
    if params.max_buckets + 1 <= 8:
        need = 2 * 32 * 292 * 4 + 15 * lc * 8
    else:
        need = lc * 12
    return firsts + need + ((w * b // params.clock + 1) * 8 if table else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ADWIN_PATHS))
def test_adwin_kernel_paths(dev, case):
    """K5-adwin equals its plain version int32-exactly on each of its
    paths, from a fresh state and from one carried over 64 elements; each
    case checks that its inputs reach the path it names."""
    params, (p, w, b) = ADWIN_PATHS[case]
    e0, v0 = (torch.from_numpy(a.reshape(p, 2, 32)).to(dev)
              for a in _adwin_late_drift(1, p, 64, flip=1.0))
    e1, v1 = (torch.from_numpy(a.reshape(p, w, b)).to(dev)
              for a in _adwin_late_drift(2, p, w * b))
    fresh = tadwin.adwin_init(params, (p,), dev)
    carried, _ = tadwin.adwin_window_reference(fresh, e0, v0, params)
    if case.startswith("global_chunk_table"):
        optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
        assert _adwin_smem_bytes(params, w, b, True) > optin
        assert _adwin_smem_bytes(params, w, b, False) + 8192 < optin
    for state in (fresh, carried):
        launches = tadwin.adwin_window.launches
        got = tadwin.adwin_window(state, e1, v1, params)
        want = tadwin.adwin_window_reference(state, e1, v1, params)
        assert tadwin.adwin_window.launches == launches + 1
        _same(got, want)
        end = want[0]
        if case == "no_flush":
            assert torch.equal(end.t // params.clock, state.t // params.clock)
        elif case == "forgets_mid_window":
            assert bool((state.n == state.t).all() and (end.n < end.t).all())
        else:
            assert int(end.counts.sum(1).min()) > 32


@pytest.mark.cuda
def test_adwin_kernel_fires_on_xla_log_tie(dev):
    """The row of ``test_adwin_fires_on_xla_log_tie``
    (tests/test_torch_detectors.py): its last flush's cut test sits within
    an ulp of its bound at n = 11,936, where XLA's ln n differs from the
    correctly rounded one. K5-adwin fires there, as its plain version and
    the JAX package do."""
    row = np.concatenate([np.zeros(10752, np.float32), np.zeros(1184, np.float32)])
    row[(np.arange(699) * 10752) // 699] = 1
    row[10752 + (np.arange(142) * 1184) // 142] = 1
    errs = torch.from_numpy(row.reshape(1, 8, 1492)).to(dev)
    valid = torch.ones_like(errs, dtype=torch.bool)
    params = tconfig.ADWINParams()
    state = tadwin.adwin_init(params, (1,), dev)
    got = tadwin.adwin_window(state, errs, valid, params)
    _same(got, tadwin.adwin_window_reference(state, errs, valid, params))
    assert got[1].first_change.cpu().numpy().tolist() == [[-1] * 7 + [1491]]


# --------------------------------------------------------------------------
# the MLP kernels K8 random_normal, K9 mlp_fit, K10 mlp_predict_err
# --------------------------------------------------------------------------

from distributed_drift_detection_tpu_torch.models import mlp as tmlp  # noqa: E402
from distributed_drift_detection_tpu_torch.utils import threefry  # noqa: E402

# K9 against its plain version: the two sum their products in other
# orders, and over a fit's steps a hidden unit's input within rounding of
# zero flips its ReLU gradient in one version only; from there that
# partition's trajectories part (1.04e-3 after 32 steps in one partition
# of the main_path case, on an H100), the others staying within 2e-6. So
# each case is held twice: after at most 4 steps every parameter to
# K9_RTOL / K9_TIGHT_ATOL, and after all its steps to K9_ATOL.
K9_RTOL, K9_TIGHT_ATOL, K9_TIGHT_STEPS = 1e-4, 2e-6, 4
K9_ATOL = 5e-2


def _keys(seed, p):
    return torch.from_numpy(threefry.split(threefry.key(seed), p).view(np.int32).copy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2560, 2688, 8192])
@pytest.mark.parametrize("factor", ["sqrt2", "init"])
def test_random_normal_kernel_bitwise(dev, factor, n):
    """K8 equals its plain version bit for bit (which is jax.random's) on
    one layer of n normals a key, in one launch."""
    f = threefry.SQRT2 if factor == "sqrt2" else tmlp.init_scales((21, 5))[0]
    keys = _keys(n, 16)
    before = threefry.init_normals.launches
    got = threefry.init_normals(keys.to(dev), [n], [f])
    assert threefry.init_normals.launches == before + 1
    want = threefry.init_normals(keys, [n], [f])
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


# K8's inits: (P, dims) — the main path's MLP(128, 64), the narrow nets,
# a layer of one normal, 65 layers (two launches, split counters past 64)
K8_INITS = {
    "main_path": (16, (21, 128, 64, 40)),
    "three_partitions": (3, (21, 128, 64, 40)),
    "narrow": (3, (5, 16, 8, 3)),
    "one_normal": (4, (1, 1, 2)),
    "no_hidden": (2, (21, 40)),
    "sixty_five_layers": (2, (7,) * 65 + (2,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K8_INITS))
def test_mlp_init_kernel_one_launch(dev, case):
    """The MLP init on the card is one K8 launch (one for each 64 layers),
    its weights and zero biases bit for bit the per-layer plain
    composition's (``split``, then a layer's normals) and the plain
    one-call version's on the card."""
    p, dims = K8_INITS[case]
    keys = _keys(p + len(dims), p)
    before = threefry.init_normals.launches
    got = tmlp.mlp_init(keys.to(dev), dims)
    torch.cuda.synchronize()
    assert threefry.init_normals.launches - before == -(-(len(dims) - 1) // 64)
    want = tmlp.mlp_init(keys, dims, normal=threefry.random_normal_reference)
    counts = [a * b for a, b in zip(dims[:-1], dims[1:])]
    plain = threefry.init_normals_reference(keys.to(dev).long(), counts, tmlp.init_scales(dims),
                                            p * sum(dims[1:]))
    flat = torch.cat([t.reshape(-1) for t in (*(g.w for g in got), *(g.b for g in got))])
    assert torch.equal(flat.view(torch.int32), plain.view(torch.int32))
    for g, r in zip(got, want):
        assert torch.equal(g.w.cpu().view(torch.int32), r.w.view(torch.int32))
        assert torch.equal(g.b.cpu(), r.b)


def _mlp_batch(seed, p, b, f, c):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(c, f)).astype(np.float32) * 2
    y = rng.integers(0, c, (p, b)).astype(np.int32)
    X = (protos[y] + 0.5 * rng.normal(size=(p, b, f))).astype(np.float32)
    w = (rng.random((p, b)) < 0.9).astype(np.float32)
    return X, y, w, protos


# (P, B, F, C, hidden, steps): the main path's shapes; B not a multiple of
# 32 with C = 5; F = 27 (≈ 223 KB of shared memory); a batch too large for
# shared memory (the global workspace); invalid rows and labels of no
# class; an all-invalid batch; narrow widths; one hidden layer; nine
# layers; the init alone.
K9_CASES = {
    "main_path": (16, 100, 21, 40, (128, 64), 32),
    "b37_c5": (4, 37, 27, 5, (128, 64), 32),
    "f27_c40": (4, 100, 27, 40, (128, 64), 32),
    "global_workspace": (3, 300, 21, 40, (128, 64), 8),
    "invalid_rows": (4, 100, 21, 40, (128, 64), 32),
    "all_invalid": (3, 100, 21, 40, (128, 64), 32),
    "narrow": (4, 50, 21, 40, (16, 8), 4),
    "one_hidden": (2, 64, 21, 40, (32,), 8),
    "nine_layers": (2, 64, 21, 40, (32,) * 8, 8),
    "sixty_five_layers": (2, 64, 21, 40, (16,) * 64, 2),
    "init_only": (16, 100, 21, 40, (128, 64), 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K9_CASES))
def test_mlp_fit_kernel(dev, case):
    """K9 against its plain version — to ``K9_RTOL``/``K9_TIGHT_ATOL``
    after ``K9_TIGHT_STEPS`` steps, within ``K9_ATOL`` after all; with no
    gradient (an all-invalid batch) and with no step, the init bit for
    bit."""
    p, b, f, c, hidden, steps = K9_CASES[case]
    dims = (f, *hidden, c)
    X, y, w, _ = _mlp_batch(len(case), p, b, f, c)
    if case == "invalid_rows":
        w[:, ::3] = 0.0
        y[0, :5] = c
        w[1] = 0.0
    if case == "all_invalid":
        w[:] = 0.0
    host = [_keys(p + b, p)] + [torch.from_numpy(a) for a in (X, y, w)]
    before = tmlp.mlp_fit.launches
    short = min(steps, K9_TIGHT_STEPS)
    got = tmlp.mlp_fit(*(t.to(dev) for t in host), dims, short)
    want = tmlp.mlp_fit_reference(*host, dims, short, 0.05, 0.9)
    for g, r in zip(got, want):
        for gv, rv in zip(g, r):
            assert gv.shape == rv.shape
            torch.testing.assert_close(gv.cpu(), rv, rtol=K9_RTOL, atol=K9_TIGHT_ATOL)
    got = tmlp.mlp_fit(*(t.to(dev) for t in host), dims, steps)
    assert tmlp.mlp_fit.launches == before + 2
    want = tmlp.mlp_fit_reference(*host, dims, steps, 0.05, 0.9)
    for g, r in zip(got, want):
        for gv, rv in zip(g, r):
            assert bool(torch.isfinite(gv).all())
            assert float((gv.cpu() - rv).abs().max()) <= K9_ATOL
    if case in ("all_invalid", "init_only"):
        init = tmlp.mlp_init(host[0], dims)
        for g, i in zip(got, init):
            assert torch.equal(g.w.cpu().view(torch.int32), i.w.view(torch.int32))
            assert torch.equal(g.b.cpu(), i.b)


# (P, B, F, C, hidden, steps) run at every cluster size K9's launcher can
# pick: the main path's shapes; a batch not a multiple of 32 with C = 5 and
# F = 27; C = 5 and hidden (16, 8), so at 8 CTAs a partition some own no
# unit of the last layer and one unit of a hidden layer; one hidden layer
# (no backward product is exchanged); no hidden layer (the logits' slice
# is written again right after the next step's start).
K9_CLUSTER_CASES = {
    "main_path": (16, 100, 21, 40, (128, 64), 32),
    "b37_c5_f27": (4, 37, 27, 5, (128, 64), 32),
    "c5_h16_8": (4, 50, 21, 5, (16, 8), 8),
    "one_hidden": (2, 64, 21, 40, (32,), 8),
    "no_hidden": (3, 40, 21, 5, (), 4),
}


def _mlp_fit_at(key, X, y, w, dims, steps, cs):
    """K9 launched through its launcher with ``cs`` CTAs a partition and
    the workspace in shared memory (``mlp_fit`` picks its own size): the
    fitted layers."""
    from distributed_drift_detection_tpu_torch import kernels

    p, dev = X.shape[0], X.device
    out = tuple(tmlp.MLPLayer(torch.empty((p, din, dout), device=dev),
                              torch.empty((p, dout), device=dev))
                for din, dout in zip(dims[:-1], dims[1:]))
    args, keep = tmlp.mlp_fit_args(key, X, y, w, dims, steps, 0.05, 0.9, out, None, cs)
    kernels.check("mlp_fit", kernels.launcher("mlp_fit")(*args, kernels.stream_handle(dev)))
    torch.cuda.synchronize()
    del keep
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cs", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(K9_CLUSTER_CASES))
def test_mlp_fit_kernel_cluster_sizes(dev, case, cs):
    """K9 with ``cs`` CTAs a partition fits the same parameters, bit for
    bit, as with one CTA a partition and as at the size ``mlp_fit`` picks
    (each output keeps its one chain)."""
    p, b, f, c, hidden, steps = K9_CLUSTER_CASES[case]
    dims = (f, *hidden, c)
    X, y, w, _ = _mlp_batch(len(case) + cs, p, b, f, c)
    w[0, ::3] = 0.0
    args = [t.to(dev) for t in [_keys(p + b, p)] + [torch.from_numpy(a) for a in (X, y, w)]]
    one = _mlp_fit_at(*args, dims, steps, 1)
    got = _mlp_fit_at(*args, dims, steps, cs)
    before = tmlp.mlp_fit.launches
    chosen = tmlp.mlp_fit(*args, dims, steps)
    assert tmlp.mlp_fit.launches == before + 1
    for g, o, h in zip(got, one, chosen):
        for gv, ov, hv in zip(g, o, h):
            assert torch.equal(gv.view(torch.int32), ov.view(torch.int32))
            assert torch.equal(hv.view(torch.int32), ov.view(torch.int32))
    if steps <= K9_TIGHT_STEPS:
        want = tmlp.mlp_fit_reference(*(t.cpu() for t in args), dims, steps, 0.05, 0.9)
        for g, r in zip(got, want):
            for gv, rv in zip(g, r):
                torch.testing.assert_close(gv.cpu(), rv, rtol=K9_RTOL, atol=K9_TIGHT_ATOL)


# (dims, B), as tests/test_torch_mlp.py's K9_SHAPES: SMOKE at F = 21 and
# F = 27, B = 37 with C = 5, the global workspace's B = 300, narrow widths,
# one hidden layer, none, nine layers
K9_SHAPES = [((21, 128, 64, 40), 100), ((27, 128, 64, 40), 100), ((27, 128, 64, 5), 37),
             ((21, 128, 64, 40), 300), ((21, 16, 8, 5), 50), ((21, 32, 40), 64), ((21, 5), 40),
             ((21, *(32,) * 8, 40), 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
@pytest.mark.parametrize("dims, b", K9_SHAPES)
def test_k9_words_is_the_kernels_count(dev, dims, b, cs):
    """``models/mlp.py`` ``_k9_words``, the Python copy that plans K9
    without a card, counts the floats of the kernel's own layout
    (``mlp_fit_words``, which sizes every launch)."""
    import ctypes

    from distributed_drift_detection_tpu_torch import kernels

    dim_arr = (ctypes.c_int * len(dims))(*dims)
    out = ctypes.c_int(0)
    kernels.check("mlp_fit_words", kernels.launcher("mlp_fit_words")(
        b, len(dims) - 1, ctypes.addressof(dim_arr), cs, ctypes.byref(out)))
    assert tmlp._k9_words(dims, b, cs) == out.value


@pytest.mark.cuda
def test_mlp_fit_kernel_matches_pinned_digest(dev):
    """K9 fits, bit for bit, the parameters of the one-CTA kernel it
    replaced: the SHA-256 of the fitted parameters on the main path's
    first training batch (32 steps of MLP(128, 64) from the main path's fit
    keys) and on chip_smoke's F = 27 batch equals the pinned digests
    (``chip_smoke.K9_MAIN_DIGEST``, ``K9_F27_DIGEST``), at the launcher's
    own choice of cluster size."""
    import chip_smoke as cs

    from distributed_drift_detection_tpu_torch import api, config

    prep = api.prepare(config.RunConfig(**cs.SMOKE, model="mlp"), device=dev)
    dims = cs.mlp_dims(prep.stream, prep.config)
    _, keys = cs.mlp_keys(torch, prep, dev)
    batch = [torch.from_numpy(a).to(dev) for a in cs.k7_main_batch(prep.batches)]
    got = tmlp.mlp_fit(keys, *batch, dims, 32, prep.config.mlp_learning_rate)
    assert cs.params_digest(got) == cs.K9_MAIN_DIGEST
    p, b, f, c, hidden, steps = cs.K9_F27
    f27 = [torch.from_numpy(a).to(dev) for a in cs.k9_f27_batch()]
    got = tmlp.mlp_fit(keys[:p].contiguous(), *f27, (f, *hidden, c), steps,
                       prep.config.mlp_learning_rate)
    assert cs.params_digest(got) == cs.K9_F27_DIGEST


def _near_ties(params, rows):
    """Rows whose two best float64 logits lie within 1e-4·(1 + |top|)."""
    h = rows.double()
    for layer in params[:-1]:
        h = torch.relu(torch.bmm(h, layer.w.double()) + layer.b.double()[:, None])
    logits = torch.bmm(h, params[-1].w.double()) + params[-1].b.double()[:, None]
    top2 = logits.topk(2, -1).values
    return (top2[..., 0] - top2[..., 1]) <= 1e-4 * (1 + top2[..., 0].abs())


# (P, N, F, C, hidden): the main path's shape; N not a multiple of the
# tile's rows with C = 5 and F = 27; narrow widths; the nets the JAX package
# runs beyond the main path's — (256, 128) and (512,), whose weights stream
# through the ring, no hidden layer, nine layers — and a hidden layer too
# wide for shared memory (the global workspace).
K10_CASES = {
    "main_path": (16, 12800, 21, 40, (128, 64)),
    "ragged_c5_f27": (3, 1000, 27, 5, (128, 64)),
    "narrow": (4, 333, 21, 40, (16, 8)),
    "h256_128": (4, 2000, 21, 40, (256, 128)),
    "h512": (4, 2000, 21, 40, (512,)),
    "no_hidden": (3, 777, 21, 40, ()),
    "nine_layers": (2, 500, 21, 40, (32,) * 8),
    "sixty_five_layers": (2, 500, 21, 40, (16,) * 64),
    "global_workspace": (2, 300, 21, 40, (4096,)),
}


def _k10_case(case, idx_dtype=torch.int16):
    """K10_CASES[case]: parameters fitted by the plain version (8 steps),
    a 3,000-row table, its labels and a gather index, on the CPU."""
    p, n, f, c, hidden = K10_CASES[case]
    dims = (f, *hidden, c)
    X, y, w, protos = _mlp_batch(len(case), p, 100, f, c)
    params = tmlp.mlp_fit_reference(_keys(7, p), *(torch.from_numpy(a) for a in (X, y, w)),
                                    dims, 8, 0.05, 0.9)
    rng = np.random.default_rng(n)
    T = torch.from_numpy((protos[rng.integers(0, c, 3000)]
                          + 0.7 * rng.normal(size=(3000, f))).astype(np.float32))
    Ty = torch.from_numpy(rng.integers(0, c, 3000).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 3000, (p, n))).to(idx_dtype)
    return params, T, Ty, idx


def _on(dev, params, *tensors):
    return (tuple(tmlp.MLPLayer(l.w.to(dev), l.b.to(dev)) for l in params),
            *(t.to(dev) for t in tensors))


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("case", sorted(K10_CASES))
def test_mlp_predict_err_kernel(dev, case, idx_dtype):
    """K10's predictions equal its plain version's on the same parameters
    except on near ties, and its errors are ``pred != label``."""
    params, T, Ty, idx = _k10_case(case, idx_dtype)
    p, n = idx.shape
    before = tmlp.mlp_predict_err.launches
    err, pred = tmlp.mlp_predict_err(*_on(dev, params, T, Ty, idx), return_pred=True)
    assert tmlp.mlp_predict_err.launches == before + 1
    rerr, rpred = tmlp.mlp_predict_err_reference(params, T, Ty, idx)
    tie = _near_ties(params, T[idx.long()])
    pred, err = pred.cpu(), err.cpu()
    assert torch.equal(pred[~tie], rpred[~tie])
    assert torch.equal(err, (pred != Ty[idx.long()]).float())
    assert int(tie.sum()) < max(5, n * p // 1000)


def _k10_at(params, T, Ty, idx, force):
    """K10 through its launcher at the plan ``force`` (rows, threads, CTAs
    a partition, stream; uncounted): (pred, err)."""
    from distributed_drift_detection_tpu_torch import kernels

    dev = idx.device
    p, n = idx.shape
    dims = (params[0].w.shape[1], *(l.w.shape[2] for l in params))
    plan = tmlp.k10_launch_plan(dev, dims, p, n, force)
    err = torch.empty((p, n), device=dev)
    pred = torch.empty((p, n), dtype=torch.int32, device=dev)
    args, keep = tmlp.mlp_predict_err_args(params, tmlp.pad_row_table(T), Ty, idx, err, pred,
                                           tmlp.k10_scratch(plan, p, dev), tmlp.k10_force(plan))
    kernels.check("mlp_predict_err", kernels.launcher("mlp_predict_err")(
        *args, kernels.stream_handle(dev)))
    torch.cuda.synchronize()
    del keep
    return pred, err


# K10 plans forced on a net (rows a tile, threads, CTAs a partition,
# stream): resident and streamed weights, one tile a CTA, 64 and 128 rows,
# 128 and 256 threads, 8 rows (one row group; a pass spans every unit).
K10_FORCED = [(128, 256, 0, 0), (128, 256, 0, 1), (64, 128, 0, 0), (64, 256, 10**6, 1),
              (128, 128, 10**6, 0), (8, 256, 0, 1), (8, 32, 3, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("force", K10_FORCED)
@pytest.mark.parametrize("case", ["main_path", "ragged_c5_f27", "no_hidden"])
def test_mlp_predict_err_kernel_plans_bit_equal(dev, case, force):
    """Every plan of K10 — both weight paths among them — gives the
    predictions and errors of the plan ``mlp_predict_err`` picks, bit for
    bit (each output keeps its one chain)."""
    params, T, Ty, idx = _on(dev, *_k10_case(case))
    err, pred = tmlp.mlp_predict_err(params, T, Ty, idx, return_pred=True)
    got_pred, got_err = _k10_at(params, T, Ty, idx, force)
    assert torch.equal(got_pred, pred)
    assert torch.equal(got_err.view(torch.int32), err.view(torch.int32))


# (dims, P, N): the main path's; C5's nets; no hidden layer; nine layers;
# the global workspace; F = 27 at few rows
K10_PLAN_SHAPES = [((21, 128, 64, 40), 16, 12800), ((21, 256, 128, 40), 16, 12800),
                   ((21, 512, 40), 16, 12800), ((21, 40), 16, 12800),
                   ((21, *(32,) * 8, 40), 2, 500), ((21, 4096, 40), 2, 300),
                   ((27, 128, 64, 5), 3, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims, p, n", K10_PLAN_SHAPES)
def test_k10_plan_is_the_kernels_plan(dev, dims, p, n):
    """``models/mlp.py`` ``k10_plan``, the Python copy that plans K10
    without a card, gives the kernel's own plan (``mlp_predict_err_plan``,
    which sizes every launch): rows, threads, CTAs a partition, weight
    path, workspace and word counts, from the card's SMs and occupancy."""
    got = tmlp.k10_kernel_plan(dev, dims, p, n)
    per_sm, sms = got[9:]
    assert sms == torch.cuda.get_device_properties(dev).multi_processor_count
    want = tmlp.k10_plan(dims, p, n, sms, lambda *_: per_sm)
    assert tmlp.K10Plan(*got[:9]) == want


@pytest.mark.cuda
def test_mlp_predict_err_kernel_matches_pinned_digest(dev):
    """K10 gives, bit for bit, the predictions and errors of the kernel it
    replaced: the SHA-256 at the main path's shape with the main path's
    first fitted params, and on chip_smoke's F = 27 case, equals the pinned
    digests (``chip_smoke.K10_MAIN_DIGEST``, ``K10_F27_DIGEST``)."""
    import chip_smoke as cs

    from distributed_drift_detection_tpu_torch import api, config

    prep = api.prepare(config.RunConfig(**cs.SMOKE, model="mlp"), device=dev)
    dims = cs.mlp_dims(prep.stream, prep.config)
    _, keys = cs.mlp_keys(torch, prep, dev)
    batch = [torch.from_numpy(a).to(dev) for a in cs.k7_main_batch(prep.batches)]
    params = tmlp.mlp_fit(keys, *batch, dims, 32, prep.config.mlp_learning_rate)
    p, n = prep.config.partitions, prep.config.window * prep.config.per_batch
    T, Ty, idx = (torch.from_numpy(a).to(dev) for a in cs.k10_main_inputs(prep.stream, p, n))
    err, pred = tmlp.mlp_predict_err(params, T, Ty, idx, return_pred=True)
    assert cs.k10_digest(pred, err) == cs.K10_MAIN_DIGEST
    ferr, fpred = tmlp.mlp_predict_err(*cs.k10_f27_case(torch, tmlp, dev), return_pred=True)
    assert cs.k10_digest(fpred, ferr) == cs.K10_F27_DIGEST


# --------------------------------------------------------------------------
# K11 and K12, the oblique forest's fit and predict + error
# --------------------------------------------------------------------------

from distributed_drift_detection_tpu_torch.models import forest as tforest  # noqa: E402
from distributed_drift_detection_tpu_torch.utils import threefry  # noqa: E402

# (P, B, F, C, trees, depth): the main path's shapes; the rialto width;
# depth 1 and 8; one tree; C = 70 (above 64); B = 300; all weights 0;
# B = 1; K12's generic layouts — rows read from the table (F = 600),
# projections read from device memory (F = 300 at 32 trees), both (F =
# 2,048) — and T = 500 (its 16-bit counters); trees across a warp's
# boundary (T = 33, 64); K11's column select past one lane's registers
# (B = 1,500, with repeated rows); K12's counters in device memory (C =
# 2,000, T = 40); a register width with a full last float4 (F = 40);
# K11's deep-tree layout (depth 12, T = 2); and repeated rows, whose
# equal keys test the stable order.
K11_CASES = {
    "main_path": (16, 100, 21, 40, 32, 3),
    "rialto": (3, 64, 27, 10, 4, 2),
    "depth1": (2, 50, 5, 3, 3, 1),
    "depth8": (2, 100, 21, 70, 1, 8),
    "one_tree": (2, 30, 7, 4, 1, 3),
    "global_workspace": (2, 300, 21, 40, 32, 3),
    "weights_0": (2, 50, 21, 40, 8, 3),
    "per_batch_1": (4, 1, 21, 40, 8, 3),
    "rows_unstaged": (2, 60, 600, 5, 4, 2),
    "params_unstaged": (2, 100, 300, 10, 32, 3),
    "wide_rows": (2, 100, 2048, 10, 32, 3),
    "global_votes": (2, 50, 21, 40, 500, 1),
    "trees33": (2, 100, 21, 40, 33, 3),
    "trees64": (2, 100, 21, 40, 64, 3),
    "b1500_repeated": (2, 1500, 21, 40, 8, 3),
    "c2000_t40": (2, 100, 21, 2000, 40, 3),
    "f40": (2, 100, 40, 10, 32, 3),
    "depth12_t2": (2, 100, 21, 40, 2, 12),
    "repeated_rows": (2, 120, 21, 6, 16, 3),
}
# K11's forced layouts (csrc/forest_fit.cu `force`): the row rule, the
# global layout, both; K12's (csrc/forest_predict_err.cu `force`): the
# generic kernel, rows from the table, projections from device memory,
# the tally in device memory, the votes kept, and mixes of them.
K11_FORCED = [1, 2, 3]
K12_FORCED = [1, 3, 4, 5, 8, 16, 24, 29]
FORCED_CASES = ["main_path", "depth8", "weights_0", "per_batch_1", "b1500_repeated",
                "trees33", "rialto"]


def _forest_batch(case):
    p, b, f, c, trees, depth = K11_CASES[case]
    rng = np.random.default_rng(len(case) + b)
    X = rng.normal(size=(p, b, f)).astype(np.float32)
    y = rng.integers(0, c, (p, b)).astype(np.int32)
    w = (rng.random((p, b)) < 0.9).astype(np.float32)
    if case == "weights_0":
        w[:] = 0.0
    if "repeated" in case:  # each run of 5 rows one row, one label
        src = np.arange(b) // 5 * 5
        X, y = X[:, src], y[:, src]
    key = torch.from_numpy(threefry.split(threefry.key(b), p).view(np.int32).copy())
    return key, X, y, w


def _fit_equal(got, host, trees, depth, c, dev):
    on_card = tforest.forest_fit_reference(*(t.to(dev) for t in host), trees, depth, c)
    on_cpu = tforest.forest_fit_reference(*host, trees, depth, c)
    for g, r, h in zip(got, on_card, on_cpu):
        if g.dtype == torch.float32:
            g, r, h = g.view(torch.int32), r.view(torch.int32), h.view(torch.int32)
        assert torch.equal(g, r) and torch.equal(g.cpu(), h)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K11_CASES))
def test_forest_fit_kernel_bitwise(dev, case):
    """K11 equals its plain version bit for bit, on the card and on the
    CPU: projections, thresholds and leaf classes."""
    p, b, f, c, trees, depth = K11_CASES[case]
    key, X, y, w = _forest_batch(case)
    host = [key] + [torch.from_numpy(a) for a in (X, y, w)]
    before = tforest.forest_fit.launches
    got = tforest.forest_fit(*(t.to(dev) for t in host), trees, depth, c)
    assert tforest.forest_fit.launches == before + 1
    _fit_equal(got, host, trees, depth, c, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("force", K11_FORCED)
@pytest.mark.parametrize("case", FORCED_CASES)
def test_forest_fit_kernel_forced_layouts(dev, case, force):
    """K11's row rule and global layout, forced at shapes that would not
    take them, equal its plain version bit for bit."""
    p, b, f, c, trees, depth = K11_CASES[case]
    key, X, y, w = _forest_batch(case)
    host = [key] + [torch.from_numpy(a) for a in (X, y, w)]
    plan = tforest.k11_plan(b, f, c, trees, depth, force)
    assert plan.counters == (not force & 1)
    if force & 2:
        assert plan.z_global and not (plan.x_staged or plan.cols_staged or plan.th_staged)
    got = tforest.forest_fit(*(t.to(dev) for t in host), trees, depth, c, force=force)
    _fit_equal(got, host, trees, depth, c, dev)


def _k12_inputs(case, idx_dtype, dev):
    p, b, f, c, trees, depth = K11_CASES[case]
    key, X, y, w = _forest_batch(case)
    params = tforest.forest_fit(*(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                                  else a.to(dev) for a in (key, X, y, w)), trees, depth, c)
    rng = np.random.default_rng(b)
    T = torch.from_numpy(rng.normal(size=(700, f)).astype(np.float32)).to(dev)
    Ty = torch.from_numpy(rng.integers(0, c, 700).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 700, (p, 1000))).to(dev, idx_dtype)
    return params, T, Ty, idx


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("case", sorted(K11_CASES))
def test_forest_predict_err_kernel_bitwise(dev, case, idx_dtype):
    """K12 on K11's fit: predictions and errors equal to the plain
    version's, through the padded and the unpadded row table."""
    c = K11_CASES[case][3]
    params, T, Ty, idx = _k12_inputs(case, idx_dtype, dev)
    before = tforest.forest_predict_err.launches
    rerr, rpred = tforest.forest_predict_err_reference(params, T, Ty, idx)
    for table in (tforest.pad_row_table(T), T):
        err, pred = tforest.forest_predict_err(params, table, Ty, idx, return_pred=True,
                                               classes=c)
        assert torch.equal(pred, rpred) and torch.equal(err, rerr)
    assert tforest.forest_predict_err.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("force", K12_FORCED)
@pytest.mark.parametrize("case", FORCED_CASES)
def test_forest_predict_err_kernel_forced_layouts(dev, case, force):
    """Each of K12's layouts, forced at shapes that would not take it,
    equal to its plain version bit for bit."""
    p, _, f, c, trees, depth = K11_CASES[case]
    params, T, Ty, idx = _k12_inputs(case, torch.int16, dev)
    plan = tforest.k12_plan(dev, p, idx.shape[1], f, trees, depth, c, force)
    assert plan.regs == (not force & 7) and plan.tally_global == bool(force & 8)
    if force & 16:
        assert plan.keep_votes
    if force & 2:
        assert not plan.rows_staged
    if force & 4:
        assert not plan.params_staged
    rerr, rpred = tforest.forest_predict_err_reference(params, T, Ty, idx)
    err, pred = tforest.forest_predict_err(params, T, Ty, idx, return_pred=True, classes=c,
                                           force=force)
    assert torch.equal(pred, rpred) and torch.equal(err, rerr)


@pytest.mark.cuda
def test_forest_workspace_counts(dev):
    """The kernels' own plans put K11's and K12's work in shared memory at
    the main path's shapes, and in device memory, or in their other
    layouts, exactly where the shapes ask for it."""
    def k11(case, force=0):
        _, b, f, c, trees, depth = K11_CASES[case]
        return tforest.k11_plan(b, f, c, trees, depth, force)

    main = k11("main_path")
    assert main.counters and main.th_staged and main.cols_staged and main.x_staged
    assert not main.z_global and main.chunk == 7 and main.words == 0
    assert tforest.forest_fit_scratch(16, 100, 21, 40, 32, 3, dev) is None
    deep = k11("depth12_t2")
    assert not deep.counters and not deep.cols_staged and 1 <= deep.chunk < 4095
    assert deep.words == 0
    forced = k11("main_path", 3)
    assert forced.ids_global and forced.z_global and forced.words == 32 * (2 * 100 + 7 * 100)
    assert tuple(tforest.forest_fit_scratch(16, 100, 21, 40, 32, 3, dev, 3).shape) == \
        (16, forced.words)

    def k12(case, force=0):
        p, _, f, c, trees, depth = K11_CASES[case]
        return tforest.k12_plan(dev, p, 1000, f, trees, depth, c, force)

    main = k12("main_path")
    assert main.regs and main.params_staged and not main.tally_global and main.bits == 8
    assert main.counter_words == 10 and not main.keep_votes and main.words == 0
    many = k12("c2000_t40")
    assert many.regs and many.tally_global and many.keep_votes
    assert many.words == 2 * many.ctas * (500 + 40) * many.threads
    work = tforest.k12_workspace(2, 1000, 21, 40, 3, 2000, dev)
    assert tuple(work.shape) == (many.words,)
    wide = k12("wide_rows")
    assert not wide.regs and not wide.rows_staged and not wide.params_staged
    assert k12("global_votes").bits == 16 and k12("global_votes").regs
    assert not k12("depth12_t2").regs and not k12("depth12_t2").params_staged


# K6: (generator, F, P, B, drift_every, count, t0, last, rows, classes)
# with rows "global" (the one-shot runner's offsets q·NB·B, no concept
# offset), "local" (the chain's partition-local rows with concept offsets
# block0s) or "top" (rows up to 2^31 - 2, the int32 ceiling)
K6_CASES = {
    "prototypes_main": ("prototypes", 8, 128, 2000, 100_000, 1, 7, 4099, "global", 8),
    "sea_main": ("sea", 3, 128, 2000, 100_000, 1, 7, 4099, "global", 2),
    "hyperplane_main": ("hyperplane", 10, 128, 2000, 100_000, 1, 7, 4099, "global", 2),
    "gradual_main": ("hyperplane_gradual", 10, 128, 2000, 100_000, 1, 7, 4099, "global", 2),
    "straddles_concepts": ("prototypes", 8, 16, 300, 700, 1, 9, 99, "global", 8),
    "chain_block0": ("hyperplane_gradual", 10, 16, 300, 600, 1, 41, 2**31 - 1, "local", 2),
    "near_int32_max": ("prototypes", 5, 4, 1000, 777, 1, 99, 99, "top", 8),
    "window_tail": ("sea", 3, 16, 100, 500, 8, 95, 99, "global", 2),
    "f1_hyperplane": ("hyperplane", 1, 4, 64, 100, 3, 0, 10, "local", 2),
    # drift_every below a tile: a tile reaches up to 38 concepts
    "de7_prototypes": ("prototypes", 8, 16, 2000, 7, 1, 9, 99, "global", 8),
    "de7_gradual": ("hyperplane_gradual", 10, 16, 2000, 7, 1, 9, 99, "global", 2),
    "de1_hyperplane": ("hyperplane", 6, 4, 600, 1, 2, 3, 99, "top", 2),
    # C·F past the staging budget (and, forced, past a CTA's shared memory)
    "classes_4096_f16": ("prototypes", 16, 4, 1000, 100_000, 1, 7, 99, "global", 4096),
    # forced staging holds 14 of a tile's 16 concepts: tiles of both layouts
    "classes_512_de18": ("prototypes", 8, 4, 300, 18, 1, 3, 99, "global", 512),
    "b_past_a_tile": ("hyperplane", 10, 8, 257, 1000, 1, 3, 99, "global", 2),
    "top_many_concepts": ("prototypes", 8, 4, 1000, 5, 1, 99, 99, "top", 8),
}


def _k6_inputs(case, dev):
    from distributed_drift_detection_tpu_torch.engine.loop import device_keys
    from distributed_drift_detection_tpu_torch.utils import threefry

    gen, f, p, b, de, count, t0, last, rows, classes = K6_CASES[case]
    keys = device_keys(threefry.split(threefry.key(p + b), p), dev)
    nb = 100
    part = torch.arange(p, dtype=torch.int64, device=dev)
    if rows == "global":
        offs, block0s = part * nb * b, torch.zeros_like(part)
    elif rows == "local":
        offs, block0s = torch.zeros_like(part), part * 12_345
    else:
        offs, block0s = part * 0 + (2**31 - 1 - nb * b), part * 3
    kw = dict(per_batch=b, features=f, drift_every=de, generator=gen, classes=classes)
    return keys, t0, count, last, offs.int(), block0s.int(), kw


@pytest.mark.cuda
@pytest.mark.parametrize("force", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_soak_batch_kernel_bitwise(dev, case, force):
    """K6 equals its plain version on the card bit for bit — the padded
    table, the labels and the row positions (−1 past ``last``) — in its
    plan's layout and forced to each (``k6_plan``): staged concept tables,
    every row's entries inline, and tiles of both where forced staging
    holds fewer concepts than a tile reaches."""
    from distributed_drift_detection_tpu_torch.engine import soak

    keys, t0, count, last, offs, block0s, kw = _k6_inputs(case, dev)
    plan = soak.k6_plan(keys.shape[0], count, kw["per_batch"], kw["features"], kw["generator"],
                        kw["classes"], kw["drift_every"], 1)
    if force == 2 and 8 + 4 * plan.per_concept > soak.K6_MAX_SHARED:
        with pytest.raises(ValueError, match="does not fit"):
            soak.soak_batch(keys, t0, count, last, offs, block0s, force=force, **kw)
        return
    before = soak.soak_batch.launches
    got = soak.soak_batch(keys, t0, count, last, offs, block0s, force=force, **kw)
    torch.cuda.synchronize()
    assert soak.soak_batch.launches == before + 1
    assert soak.soak_batch.plan == soak.k6_plan(
        keys.shape[0], count, kw["per_batch"], kw["features"], kw["generator"], kw["classes"],
        kw["drift_every"], force)
    want = soak.soak_batch_reference(keys, t0, count, last, offs, block0s, **kw)
    assert torch.equal(got.table.view(torch.int32), want.table.view(torch.int32))
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.rows, want.rows)
    if case == "window_tail":
        assert bool((got.rows[:, 5:] == -1).all()) and bool((got.rows[:, :5] >= 0).all())
    again = soak.soak_batch(keys, t0, count, last, offs, block0s, out=got, force=force, **kw)
    assert again is got and torch.equal(again.table.view(torch.int32), want.table.view(torch.int32))


@pytest.mark.cuda
def test_soak_runner_on_the_card_matches_the_cpu(dev):
    """The soak at a small geometry, each generator and a window run: the
    card's flags equal the CPU's, K6 launched once a batch."""
    from distributed_drift_detection_tpu_torch.engine import soak
    from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model
    from distributed_drift_detection_tpu_torch.utils import threefry

    geom = dict(partitions=4, per_batch=100, num_batches=30, drift_every=1000)
    for gen, f, kw in (("prototypes", 8, {}), ("sea", 3, {}), ("hyperplane", 10, {}),
                       ("hyperplane_gradual", 10, {}), ("prototypes", 8, dict(window=4))):
        model = build_model("centroid", ModelSpec(f, 8 if gen == "prototypes" else 2))
        runs = []
        for d in ("cpu", dev):
            before = soak.soak_batch.launches
            runs.append(soak.make_soak_runner(model, generator=gen, device=d, **geom, **kw)(
                threefry.key(0)))
        assert soak.soak_batch.launches - before == (30 if not kw else 1 + 4)
        for name in runs[0].flags._fields:
            assert torch.equal(getattr(runs[0].flags, name), getattr(runs[1].flags, name).cpu())


# K13 (ops/shuffle.py shuffle_planes): (P, W, B) — B = 1 (no round), the
# one-round edge 1625, two rounds from 1626, a B past shared memory (the
# global path), the window engine's main-path launch (16, 128, 100); each
# path's edges (ops/shuffle.py k13_layout): the warp path's 32-place floor
# (16, 17, 32, 33) and its last B (1024), the CTA path's first (1025) and
# last (16384), the global path's first (16385); grids of 15 batches, not a
# multiple of the warp path's batches a CTA (P = 3, W = 5).
K13_SHAPES = [(16, 1, 1), (16, 128, 2), (16, 128, 100), (3, 7, 1625), (3, 7, 1626),
              (2, 3, 2000), (16, 1, 20000), (2, 128, 20000),
              (3, 5, 16), (3, 5, 17), (16, 128, 32), (16, 128, 33), (16, 128, 1024),
              (3, 5, 1025), (2, 9, 16384), (2, 3, 16385), (2, 5, 4096), (2, 5, 4097), (2, 5, 8192), (2, 5, 8193)]
K13_EDGE_BS = (1, 2, 16, 17, 32, 33, 100, 1024, 1025, 1625, 1626, 4096, 4097, 8192, 8193,
               16384, 16385, 20000)


def _k13_inputs(dev, p, nb, b, idx_dtype, seed=0):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, 30000, (p, nb, b)).astype(np.int64)).to(idx_dtype)
    rows = torch.from_numpy(rng.integers(-1, 2**31 - 1, (p, nb, b), dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy(rng.random((p, nb, b)) < 0.8)
    return idx.to(dev), rows.to(dev), valid.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K13_SHAPES)
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("derive", [True, False])
def test_shuffle_perm_kernel_bitwise(dev, shape, idx_dtype, derive):
    """K13 equals its plain version bit for bit: the window engine's keys
    (one a partition, split W ways) with each lane's start, and the loop
    engine's (one a batch)."""
    from distributed_drift_detection_tpu_torch.ops import shuffle

    p, w, b = shape
    nb = w + 5
    idx, rows, valid = _k13_inputs(dev, p, nb, b, idx_dtype)
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(
        rng.integers(0, 2**32, (p, 2) if derive else (p, w, 2), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(dev)
    start = torch.from_numpy(rng.integers(0, 6, p)).to(dev) if derive else None
    before = shuffle.shuffle_planes.launches
    got = shuffle.shuffle_planes(keys, idx, rows, valid, w, start, derive=derive)
    assert shuffle.shuffle_planes.launches == before + 1
    want = shuffle.shuffle_planes_reference(keys, idx, rows, valid, w, start, derive=derive)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("tie_mask", [0, 0x3, 0xFF00])
@pytest.mark.parametrize("force", [0, 1])
def test_shuffle_perm_kernel_ties_and_paths(dev, tie_mask, force):
    """Draws forced to tie (ANDed with ``tie_mask``): the kernel's order is
    still the stable sort's; on the warp path (17, 100), the CTA path with
    one round (1025), two (1626) and 32 composites a thread (4097), and
    forced to the global one."""
    from distributed_drift_detection_tpu_torch.ops import shuffle

    for b in (17, 100, 1025, 1626, 4097):
        idx, rows, valid = _k13_inputs(dev, 4, 9, b, torch.int32, seed=b)
        keys = torch.arange(8, dtype=torch.int32, device=dev).view(4, 2) * 7919
        got = shuffle.shuffle_planes(keys, idx, rows, valid, 9, derive=True,
                                     tie_mask=tie_mask, force=force)
        want = shuffle.shuffle_planes_reference(keys, idx, rows, valid, 9, derive=True,
                                                tie_mask=tie_mask)
        for g, r in zip(got, want):
            assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("force", [0, 1])
def test_shuffle_perm_path_is_k13_layout(dev, force):
    """The layout K13's library takes (``shuffle_perm_path``: path, network
    width, composites a thread, threads and batches a CTA, shared bytes)
    is ``k13_layout``'s at every path edge, on its own and forced to the
    global path."""
    import ctypes

    from distributed_drift_detection_tpu_torch import kernels
    from distributed_drift_detection_tpu_torch.ops import shuffle

    fn = kernels.launcher("shuffle_perm_path")
    for b in K13_EDGE_BS:
        out = (ctypes.c_int * 6)()
        assert fn(b, force, out) == 0
        got = dict(zip(("path", "npow2", "per_thread", "threads", "warps", "shared_bytes"), out))
        got["path"] = shuffle.K13_PATHS[got["path"]]
        assert got == shuffle.k13_layout(b, force), b


def _k4_plane(dev, p, nbf, density, seed):
    """A packed ``[5, P, NBF]`` flag plane: warnings, changes and forced
    retrains at ``density`` of the slots."""
    g = torch.Generator().manual_seed(seed)
    hit = torch.rand((p, nbf), generator=g) < density
    kind = torch.randint(0, 3, (p, nbf), generator=g)
    val = torch.randint(0, 5000, (p, nbf), generator=g, dtype=torch.int32)
    warn = torch.where(hit & (kind == 0), val, -1)
    change = torch.where(hit & (kind == 1), val, -1)
    forced = (hit & (kind == 2)).int()
    return torch.stack([warn, warn * 3, change, change * 3, forced]).int().to(dev)


# (P, NBF, density, capacity, partition offset): the main path's shard and
# plane (SMOKE: 16 x 1,279 at its auto capacity 2,558; 4 shards of 4),
# overflow, nothing flagged, every slot flagged, K = 1, K at and past the
# slot count, one slot, no batch column, a plane of one tile (2,048
# slots) and a plane of hundreds of tiles (the look-back chain).
K4_CASES = [(16, 1279, 0.03, 2558, 0), (4, 1279, 0.03, 2558, 12), (16, 1279, 0.5, 2558, 0),
            (16, 1279, 0.0, 2558, 0), (16, 1279, 1.0, 2558, 0), (16, 1279, 1.0, 100, 3),
            (8, 100, 0.2, 1, 0), (8, 100, 0.2, 800, 0), (8, 100, 1.0, 900, 5), (1, 1, 1.0, 1, 7),
            (5, 0, 0.5, 64, 0), (2, 1024, 0.1, 64, 0), (128, 5000, 0.02, 80000, 0),
            (128, 5000, 0.3, 80000, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flag_compact_matches_plain(dev, case):
    """K4 against its plain version, byte for byte, the count row included,
    on a packed plane and on its FlagRows."""
    from distributed_drift_detection_tpu_torch.engine.loop import FlagRows
    from distributed_drift_detection_tpu_torch.parallel import mesh

    p, nbf, density, k, off = case
    packed = _k4_plane(dev, p, nbf, density, seed=p * nbf + k)
    before = mesh.compact_flag_table.launches
    got = mesh.compact_flag_table(packed, k, off)
    want = mesh.compact_flag_table_reference(packed, k, off)
    assert mesh.compact_flag_table.launches == before + 1
    assert got.shape == (k + 1, 7) and got.dtype == torch.int32
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
    flags = FlagRows(packed[0], packed[1], packed[2], packed[3], packed[4].bool())
    assert torch.equal(mesh.compact_flag_table(flags, k, off), want)


@pytest.mark.cuda
def test_flag_compact_merge_on_the_card(dev):
    """Four shards' K4 tables merged on the card are the whole plane's
    table, when a shard overflows and when only the sum does."""
    from distributed_drift_detection_tpu_torch.parallel import mesh

    for density, k in ((0.3, 500), (0.02, 300), (0.03, 2558)):
        packed = _k4_plane(dev, 16, 1279, density, seed=k)
        want = mesh.compact_flag_table_reference(packed, k)
        tables = [mesh.compact_flag_table(packed[:, s * 4:(s + 1) * 4], k, s * 4)
                  for s in range(4)]
        assert torch.equal(mesh.merge_compact_tables(tables, k), want)
