"""Synthetic class-concept stream generators (``synth:`` dataset specs).

The port's own copy of the four generators the JAX package registers in
``io/synth.py`` — the same numpy calls in the same order, so a spec gives
byte-identical ``(X, y)`` in both packages (``tests/test_torch_stream.py``).
Each returns raw ``X [N, F] f32`` and ``y [N] i32``; ``io.stream``'s
``synthesize_stream`` then scales, shuffles and sorts them into a stream.
:func:`sea_chunk` and :func:`hyperplane_chunk` are the chunk-exact endless
generators the chunk feeder draws from (``io.feeder.generator_chunks``).
"""

from __future__ import annotations

import numpy as np


def planted_prototypes_xy(
    seed: int = 0,
    concepts: int = 8,
    rows_per_concept: int = 400,
    features: int = 7,
    noise: float = 0.05,
    label_flip: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Concept k = noisy copies of prototype k, labelled k: a concept-sorted
    stream whose every concept switch is a planted drift boundary."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(concepts, features)).astype(np.float32) * 3.0
    X = np.concatenate(
        [
            protos[k]
            + noise * rng.normal(size=(rows_per_concept, features)).astype(np.float32)
            for k in range(concepts)
        ]
    ).astype(np.float32)
    y = np.repeat(np.arange(concepts, dtype=np.int32), rows_per_concept)
    if label_flip:
        flip = rng.random(len(y)) < label_flip
        y[flip] = rng.integers(0, concepts, flip.sum()).astype(np.int32)
    return X, y


def rialto_like_xy(
    seed: int = 0,
    classes: int = 10,
    rows_per_class: int = 8225,
    features: int = 27,
    class_sep: float = 1.6,
    within_rank: int = 6,
    label_noise: float = 0.02,
) -> tuple[np.ndarray, np.ndarray]:
    """Stand-in for the Rialto-bridge stream (82,250 rows × 27 features ×
    10 classes): class clusters with low-rank anisotropic within-class
    covariance and a little label noise, rows class-interleaved."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(classes, features)).astype(np.float32) * class_sep
    factors = rng.normal(size=(classes, within_rank, features)).astype(np.float32)
    n = classes * rows_per_class
    y = np.tile(np.arange(classes, dtype=np.int32), rows_per_class)
    z = rng.normal(size=(n, within_rank)).astype(np.float32)
    X = (
        protos[y]
        + np.einsum("nr,nrf->nf", z, factors[y]) * 0.4
        + 0.15 * rng.normal(size=(n, features)).astype(np.float32)
    )
    flip = rng.random(n) < label_noise
    y = y.copy()
    y[flip] = rng.integers(0, classes, int(flip.sum())).astype(np.int32)
    return X.astype(np.float32), y


def _class_protos(rng, classes: int, features: int, sep: float) -> np.ndarray:
    return rng.normal(size=(classes, features)).astype(np.float32) * sep


def gradual_drift_xy(
    seed: int = 0,
    concepts: int = 4,
    rows_per_concept: int = 1000,
    features: int = 12,
    classes: int = 8,
    transition: int = 200,
    noise: float = 1.0,
    class_sep: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-concept class prototypes over a fixed label domain, with the next
    concept bleeding in over the last ``transition`` rows of each."""
    if not 0 <= transition <= rows_per_concept:
        raise ValueError(
            f"transition must be in [0, rows_per_concept], got {transition}"
        )
    rng = np.random.default_rng(seed)
    protos = np.stack(
        [_class_protos(rng, classes, features, class_sep) for _ in range(concepts)]
    )  # [K, C, F]
    n = concepts * rows_per_concept
    y = rng.integers(0, classes, n).astype(np.int32)
    rows = np.arange(n)
    k = rows // rows_per_concept
    pos = rows % rows_per_concept
    ramp = (
        np.clip(
            (pos - (rows_per_concept - transition)) / transition, 0.0, 1.0
        )
        if transition
        else np.zeros(n)
    )
    use_next = (rng.random(n) < ramp) & (k < concepts - 1)
    eff = np.where(use_next, np.minimum(k + 1, concepts - 1), k)
    X = protos[eff, y] + noise * rng.normal(size=(n, features)).astype(
        np.float32
    )
    return X.astype(np.float32), y


def recurring_drift_xy(
    seed: int = 0,
    concepts: int = 6,
    rows_per_concept: int = 1000,
    features: int = 12,
    classes: int = 8,
    period: int = 2,
    noise: float = 1.0,
    class_sep: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Concept ``k`` reuses prototype set ``k % period``: seasons recur."""
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    rng = np.random.default_rng(seed)
    pool = np.stack(
        [_class_protos(rng, classes, features, class_sep) for _ in range(period)]
    )  # [S, C, F]
    n = concepts * rows_per_concept
    y = rng.integers(0, classes, n).astype(np.int32)
    k = np.arange(n) // rows_per_concept
    eff = (k % period).astype(np.int64)
    X = pool[eff, y] + noise * rng.normal(size=(n, features)).astype(
        np.float32
    )
    return X.astype(np.float32), y


SYNTH_REGISTRY = {
    "rialto": rialto_like_xy,
    "prototypes": planted_prototypes_xy,
    "gradual": gradual_drift_xy,
    "recurring": recurring_drift_xy,
}


def parse_synth(spec: str) -> tuple[np.ndarray, np.ndarray]:
    """Resolve a ``synth:`` spec (without the prefix) to raw ``(X, y)``.

    Grammar: ``name[,key=value]...`` with numeric values, e.g.
    ``prototypes,seed=0,concepts=40``.
    """
    name, _, rest = spec.partition(",")
    try:
        fn = SYNTH_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown synthetic dataset {name!r}; known: {sorted(SYNTH_REGISTRY)}"
        ) from None
    kw = {}
    if rest:
        for item in rest.split(","):
            if not item.strip():
                continue
            k, sep, v = item.partition("=")
            if not sep:
                raise ValueError(
                    f"bad synth spec item {item!r}; expected key=value "
                    f"(spec grammar: name[,key=value]...)"
                )
            try:
                num = int(v)
            except ValueError:
                try:
                    num = float(v)
                except ValueError:
                    raise ValueError(
                        f"bad synth spec value {item!r}; values must be numeric"
                    ) from None
            kw[k.strip()] = num
    return fn(**kw)


# SEA concept thresholds (Street & Kim 2001): label = f0 + f1 <= theta.
_SEA_THETAS = (8.0, 9.0, 7.0, 9.5)


def sea_chunk(seed: int, start: int, stop: int, drift_every: int, noise: float = 0.0):
    """Rows [start, stop) of an endless SEA stream with abrupt drifts (the
    JAX package's ``sea_chunk``): features ~ U[0,10)^3, the concept of
    block ``row // drift_every`` cycles through the four SEA thresholds,
    ``noise`` flips that fraction of labels. Chunk-exact: the same rows
    whatever the chunking (``utils.prng.row_uniforms``)."""
    from ..utils.prng import row_uniforms

    n = stop - start
    rows = np.arange(start, stop, dtype=np.int64)
    u = row_uniforms(seed, start, n, per_row=4, stream_id=0)
    X = (u[:, :3] * 10.0).astype(np.float32)
    theta = np.asarray(_SEA_THETAS, np.float32)[(rows // drift_every) % len(_SEA_THETAS)]
    y = (X[:, 0] + X[:, 1] <= theta).astype(np.int32)
    if noise:
        y[u[:, 3] < noise] ^= 1
    return X, y


def hyperplane_chunk(
    seed: int,
    start: int,
    stop: int,
    features: int = 10,
    drift_every: int = 0,
    rotate_scale: float = 0.0,
):
    """Rows [start, stop) of a rotating-hyperplane stream (the JAX
    package's ``hyperplane_chunk``): ``label = (w_c · x > 0.5·Σw_c)`` with
    weights per concept block (``drift_every`` > 0: abrupt redraws) and an
    optional gradual rotation (``rotate_scale`` > 0). Chunk-exact like
    :func:`sea_chunk`."""
    from ..utils.prng import row_uniforms

    n = stop - start
    rows = np.arange(start, stop, dtype=np.int64)
    X = row_uniforms(seed, start, n, per_row=features, stream_id=1).astype(np.float32)
    if drift_every > 0:
        blocks = rows // drift_every
        uniq = np.unique(blocks)
        w = np.stack(
            [row_uniforms(seed, int(b), 1, features, stream_id=2)[0] for b in uniq]
        ).astype(np.float32)
        w_rows = w[np.searchsorted(uniq, blocks)]
    else:
        base = row_uniforms(seed, 0, 1, features, stream_id=2)[0].astype(np.float32)
        w_rows = np.broadcast_to(base, (n, features)).copy()
    if rotate_scale:
        phase = (rows[:, None] * rotate_scale).astype(np.float32)
        w_rows = w_rows + 0.3 * np.sin(phase + np.arange(features, dtype=np.float32))
    margin = (X * w_rows).sum(1) - 0.5 * w_rows.sum(1)
    y = (margin > 0).astype(np.int32)
    return X, y
