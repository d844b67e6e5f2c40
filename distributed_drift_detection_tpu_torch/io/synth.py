"""Synthetic class-concept stream generators (``synth:`` dataset specs).

The port's own copy of the four generators the JAX package registers in
``io/synth.py`` — the same numpy calls in the same order, so a spec gives
byte-identical ``(X, y)`` in both packages (``tests/test_torch_stream.py``).
Each returns raw ``X [N, F] f32`` and ``y [N] i32``; ``io.stream``'s
``synthesize_stream`` then scales, shuffles and sorts them into a stream.
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
