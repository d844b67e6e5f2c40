"""The port's threefry2x32 (``utils/threefry.py``) against ``jax.random``.

jax 0.9.0 with ``jax_threefry_partitionable`` on (its default): ``key``,
``split``, ``random_bits``, ``uniform`` and ``normal`` bit for bit, in the
numpy form and the torch form; ``normal``'s float32 map on every one of the
2^23 values the uniform can take; and the engines' key chains — the window
engine's ``key, k_fit, k_shuf = split(key, 3)`` with one fit key a level,
the ``window=1`` loop's ``key, k_shuf, k_fit = split(key, 3)`` — for a few
iterations at R = 1 and R = 4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from distributed_drift_detection_tpu_torch.utils import threefry  # noqa: E402

SEEDS = [0, 1, 42, 2**31 - 1, -7]


def _data(key):
    return np.asarray(jax.random.key_data(key))


def _torch_key(key_data):
    return torch.from_numpy(np.asarray(key_data, np.uint32).astype(np.int64))


def test_partitionable_mode_is_on():
    """The port follows the partitionable layout of split and bits."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    got = threefry.key(seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, _data(jax.random.key(seed)))


@pytest.mark.parametrize("n", [2, 3, 16])
@pytest.mark.parametrize("seed", [0, 42, -7])
def test_split_matches_jax(seed, n):
    want = _data(jax.random.split(jax.random.key(seed), n))
    np.testing.assert_array_equal(threefry.split(threefry.key(seed), n), want)
    np.testing.assert_array_equal(
        threefry.split(_torch_key(threefry.key(seed)), n).numpy(), want
    )


def test_split_of_a_batch_of_keys():
    """``[P, 2]`` keys split row by row, as a vmapped split does."""
    keys = jax.random.split(jax.random.key(5), 6)
    want = _data(jax.vmap(lambda k: jax.random.split(k, 4))(keys))
    np.testing.assert_array_equal(threefry.split(_data(keys), 4), want)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (1000,)])
@pytest.mark.parametrize("seed", [0, 3])
def test_random_bits_matches_jax(seed, shape):
    k = jax.random.key(seed)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
    np.testing.assert_array_equal(threefry.random_bits(threefry.key(seed), shape), want)
    got = threefry.random_bits(_torch_key(threefry.key(seed)), shape).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("lo, hi", [(0.0, 1.0), (-3.0, 5.5), (-1e-3, 2e-3)])
@pytest.mark.parametrize("shape", [(9,), (4, 33)])
def test_uniform_matches_jax(shape, lo, hi):
    for seed in (0, 11):
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape, minval=lo, maxval=hi))
        got = threefry.uniform(threefry.key(seed), shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 4), (21, 128), (4096,)])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = threefry.normal(threefry.key(seed), shape).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_map_exhaustive():
    """``normal``'s float32 value is a function of the 23 bits its uniform
    keeps: XLA's erf_inv of ``unit·2 + nextafter(−1, 0)``, times √2. Every
    one of the 2^23 values equals JAX's, bit for bit (the map jitted from
    the bits as ``jax.random.normal`` compiles it)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))

    def jax_map(bits):
        fb = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
        f = lax.bitcast_convert_type(fb, jnp.float32) - jnp.float32(1)
        u = lax.max(jnp.float32(lo), f * (jnp.float32(1) - jnp.float32(lo)) + jnp.float32(lo))
        return lax.mul(np.float32(np.sqrt(2)), lax.erf_inv(u))

    mant = np.arange(2**23, dtype=np.uint32)
    want = np.asarray(jax.jit(jax_map)(mant << np.uint32(9)))
    unit = torch.from_numpy((mant | np.uint32(0x3F800000)).view(np.float32)) - 1.0
    got = threefry.normal_map(unit).numpy()
    differ = int((got.view(np.int32) != want.view(np.int32)).sum())
    assert differ == 0, f"{differ} of 2^23 normals differ from JAX's"


@pytest.mark.parametrize("din", [21, 64, 128])
def test_random_normal_factor_is_the_jitted_scale(din):
    """``random_normal_reference(keys, n, f32(√2·scale))`` is XLA's jitted
    ``scale * normal``: the two constants folded into one factor (the MLP's
    init)."""
    from distributed_drift_detection_tpu_torch.models.mlp import init_scales

    keys = jax.random.split(jax.random.key(9), 3)
    scale = jnp.sqrt(2.0 / din)
    want = np.asarray(jax.jit(jax.vmap(lambda k: scale * jax.random.normal(k, (din * 5,))))(keys))
    factor = init_scales((din, 5))[0]
    got = threefry.random_normal_reference(_torch_key(_data(keys)), din * 5, factor).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _jax_window_chain(keys, iters, levels):
    """The JAX window engine's chain (engine/window.py :195-201) over
    ``iters`` iterations, every lane active."""
    fits = []
    for _ in range(iters):
        split = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys, k_fit = split[:, 0], split[:, 1]
        if levels == 1:
            fits.append(_data(k_fit)[None])
        else:
            fits.append(np.moveaxis(_data(jax.vmap(lambda k: jax.random.split(k, levels))(k_fit)), 1, 0))
    return np.stack(fits), _data(keys)


@pytest.mark.parametrize("levels", [1, 4])
def test_window_key_chain_matches_jax(levels):
    keys = jax.random.split(jax.random.key(3), 5)
    want_fits, want_last = _jax_window_chain(keys, 6, levels)
    chain, fits = threefry.window_fit_keys(_data(keys), 6, levels)
    assert fits.shape == (6, levels, 5, 2) and chain.shape == (7, 5, 2)
    np.testing.assert_array_equal(fits, want_fits)
    np.testing.assert_array_equal(chain[-1], want_last)
    np.testing.assert_array_equal(chain[0], _data(keys))


def test_loop_key_chain_matches_jax():
    """The ``window=1`` loop takes its fit key third (engine/loop.py :289)."""
    keys = jax.random.split(jax.random.key(8), 4)
    fits, k = [], keys
    for _ in range(5):
        split = jax.vmap(lambda kk: jax.random.split(kk, 3))(k)
        k, k_fit = split[:, 0], split[:, 2]
        fits.append(_data(k_fit))
    chain, got = threefry.loop_fit_keys(_data(keys), 5)
    np.testing.assert_array_equal(got, np.stack(fits))
    np.testing.assert_array_equal(chain[-1], _data(k))


def test_init_key_split_matches_the_engines():
    """Both runners split the partition key once for the init:
    ``key, k_init = split(key)``."""
    keys = jax.random.split(jax.random.key(0), 3)
    pair = jax.vmap(jax.random.split)(keys)
    np.testing.assert_array_equal(threefry.split(_data(keys), 2), _data(pair))
