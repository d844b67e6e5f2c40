"""Benchmark-dataset helpers (reference C16; the port's own copy of the JAX
package's ``io/datasets.py``).

The reference names two benchmarks: ``outdoorStream.csv`` (committed, 4,000
rows × 21 features × 40 classes) and ``rialto.csv`` — referenced throughout
(``DDM_Process.py:33`` sets 27 features for it; ``Plot Results.ipynb``
cell 2 switches datasets) but absent from its repo as a large blob
(``.MISSING_LARGE_BLOBS``). Both are expected as numeric CSVs whose header
names the feature columns ``"0".."N-1"`` plus a ``"target"`` column
(``DDM_Process.py:33-35``); :func:`..io.stream.load_csv` consumes exactly
that schema, so a real ``rialto.csv`` runs unchanged via
``RunConfig(dataset="/path/to/rialto.csv")``.

The real dataset is the **Rialto Bridge Timelapse** stream (Losing, Hammer &
Wersing 2016, "KNN Classifier with Self Adjusting Memory for Heterogeneous
Concept Drift", ICDM): 82,250 rows × 27 colour-histogram features × 10
classes (buildings around Venice's Rialto bridge photographed across 20
days). Its canonical public mirror — the authors' ``driftDatasets``
repository (github.com/vlosing/driftDatasets, ``realWorld/rialto/``) —
ships it as a *pair* of whitespace-separated files (``rialto.data``
features, ``rialto.labels`` integer labels), not as the single CSV the
reference expects. :func:`convert_data_labels_to_csv` performs that
conversion; see the README "The rialto dataset" section for the end-to-end
recipe and for what the committed ``synth:rialto`` stand-in does and does
not reproduce.
"""

from __future__ import annotations

import numpy as np


def convert_data_labels_to_csv(
    data_path: str, labels_path: str, out_csv: str
) -> tuple[int, int]:
    """``(X.data, y.labels)`` pair → the reference's single-CSV schema.

    Writes ``out_csv`` with header ``0,1,…,F-1,target`` (the exact schema
    ``DDM_Process.py:33-35`` declares and ``io.stream.load_csv`` parses).
    Features are written with full float precision; labels as integers.
    Returns ``(rows, features)``.
    """
    # ndmin pins the rank: without it a one-row file of F features loads as
    # shape (F,) and would be misread as F single-feature rows.
    X = np.loadtxt(data_path, dtype=np.float64, ndmin=2)
    y = np.loadtxt(labels_path, dtype=np.int64, ndmin=1)
    if len(X) != len(y):
        raise ValueError(
            f"{data_path} has {len(X)} rows but {labels_path} has {len(y)}"
        )
    return _write_schema_csv(X, y, out_csv)


def _write_schema_csv(X, y, out_csv: str) -> tuple[int, int]:
    """Write ``(X, y)`` in the reference's CSV schema (header
    ``0..F-1,target``, full-precision floats, integer labels)."""
    n, f = X.shape
    header = ",".join([*map(str, range(f)), "target"])
    with open(out_csv, "w") as fh:
        fh.write(header + "\n")
        for i in range(n):
            fh.write(
                ",".join(repr(float(v)) for v in X[i]) + f",{int(y[i])}\n"
            )
    return n, f


def rialto_fixture_csv(
    out_csv: str, rows_per_class: int = 20, seed: int = 0
) -> tuple[int, int]:
    """A tiny CSV in the real rialto schema (header ``0..26,target``, 10
    classes) for loader tests — geometry-faithful, content synthetic."""
    from .synth import rialto_like_xy

    X, y = rialto_like_xy(seed=seed, rows_per_class=rows_per_class)
    return _write_schema_csv(X, y, out_csv)
