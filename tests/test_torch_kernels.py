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
    valid[1] = False  # an all-padding row
    return errs, valid


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 5, 20), (16, 128, 100), (3, 7, 33)])
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
