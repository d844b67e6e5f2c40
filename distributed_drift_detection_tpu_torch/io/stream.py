"""Stream synthesis and partition striping (host side, numpy).

The port's own copy of the JAX package's ``io/stream.py`` functions on the
main path — the same numpy operations in the same order, so planes are
byte-identical across the packages (``tests/test_torch_stream.py``):

* :func:`synthesize_stream` scales the stream's volume by ``mult_data``
  (fraction-sample below 1, duplicate ×N otherwise), shuffles with a seed
  and sorts by label, so each class is one planted concept;
* :func:`stripe_partitions` places row ``i`` on partition ``i % P`` and pads
  each partition to a rectangular ``[P, NB, B]`` grid with a validity plane;
* :func:`stripe_partitions_packed` is the compressed form the main path
  uploads: row-table gather indices plus a one-byte per-batch permutation;
* :func:`stripe_chunk` and the pooled :class:`ChunkStriper` stripe one
  span of a stream at a time (the chunked engine's feed, ``io.feeder``),
  in float32 or as a bfloat16 transport plane.

Datasets are ``synth:`` specs or CSVs: :func:`load_csv` (the native parser
of ``io.native``, with its NumPy fallback) or, under a ``data_policy``,
``io.sanitize.load_csv_sane`` — whose quarantine mask ``row_ok`` rides the
stream, is folded into the validity plane by the dense striper, and keeps a
masked stream off the packed one.
"""

from __future__ import annotations

import numpy as np

from ..engine.loop import Batches, PackedIndexedBatches


class StreamData:
    """A prepared drift stream (host-side, numpy).

    A stream synthesized by integer duplication (``mult_data >= 1``) is
    stored compressed: ``base_X``/``base_y`` (the row table) plus ``src``
    (stream position → table row), with ``X == base_X[src]``; the dense
    ``X``/``y`` views materialize lazily on first access.
    """

    def __init__(
        self,
        X: np.ndarray | None = None,  # [N, F] f32
        y: np.ndarray | None = None,  # [N] i32, labels re-indexed to 0..C-1
        num_classes: int = 0,
        dist_between_changes: int = 0,  # rows // classes
        base_X: np.ndarray | None = None,  # [T, F] f32 deduplicated row table
        base_y: np.ndarray | None = None,  # [T] i32
        src: np.ndarray | None = None,  # [N] i32: stream position → table row
        row_ok: np.ndarray | None = None,  # [N] bool; None = every row valid
        base_ok: np.ndarray | None = None,  # [T] bool table-row validity
        quarantine=None,  # io.sanitize.QuarantineReport | None
    ):
        assert (X is not None and y is not None) or src is not None
        self._X = X
        self._y = y
        self.num_classes = num_classes
        self.dist_between_changes = dist_between_changes
        self.base_X = base_X
        self.base_y = base_y
        self.src = src
        # The quarantine mask (io.sanitize): False = the row broke the
        # stream contract and is carried positionally — zero content,
        # masked at stripe time like padding. Compressed streams keep the
        # table rows' mask and expand it lazily, like X/y.
        self._row_ok = row_ok
        self.base_ok = base_ok
        self.quarantine = quarantine

    @property
    def X(self) -> np.ndarray:
        if self._X is None:
            self._X = self.base_X[self.src]
        return self._X

    @property
    def y(self) -> np.ndarray:
        if self._y is None:
            self._y = self.base_y[self.src]
        return self._y

    @property
    def row_ok(self) -> np.ndarray | None:
        if self._row_ok is None and self.base_ok is not None:
            self._row_ok = self.base_ok[self.src]
        return self._row_ok

    @property
    def has_masked_rows(self) -> bool:
        """True when any row is quarantine-masked (checked without
        materializing the per-position mask of a compressed stream)."""
        return self._row_ok is not None or self.base_ok is not None

    @property
    def num_rows(self) -> int:
        return len(self.src) if self.src is not None else len(self._y)

    @property
    def num_features(self) -> int:
        return (self.base_X if self.base_X is not None else self._X).shape[1]


def load_csv(path: str, target_column: str = "target") -> tuple[np.ndarray, np.ndarray]:
    """Load a numeric CSV with a named target column: ``(X [N, F] f32,
    y [N] i64)``.

    The native parser (``io.native``) when it is available, else NumPy's.
    A native column count that disagrees with the header is warned about
    before the NumPy re-parse; if NumPy disagrees too, the load fails with
    both counts. For the policy-aware loader see
    ``io.sanitize.load_csv_sane``.
    """
    with open(path) as fh:
        header = fh.readline().strip().split(",")
    if target_column not in header:
        raise ValueError(
            f"{path}: target column {target_column!r} not in header; "
            f"columns found: {header}"
        )
    tcol = header.index(target_column)

    from .native import load_csv_native

    raw = load_csv_native(path)
    if raw is not None and raw.shape[1] != len(header):
        import warnings

        warnings.warn(
            f"{path}: native parser returned {raw.shape[1]} column(s) but "
            f"the header names {len(header)}; re-parsing with NumPy",
            stacklevel=2,
        )
        raw = None
    if raw is None:
        raw = np.loadtxt(
            path, delimiter=",", skiprows=1, dtype=np.float32, ndmin=2
        )
        if raw.shape[1] != len(header):
            raise ValueError(
                f"{path}: data rows have {raw.shape[1]} column(s) but the "
                f"header names {len(header)} ({header}); both parsers "
                "disagree with the header — fix the file or the header"
            )
    mask = np.ones(len(header), bool)
    mask[tcol] = False
    return raw[:, mask], raw[:, tcol].astype(np.int64)


def synthesize_stream(
    X: np.ndarray,
    y: np.ndarray,
    mult_data: float = 1.0,
    seed: int = 0,
    standardize: bool = True,
    row_ok: np.ndarray | None = None,
) -> StreamData:
    """Volume-scale, shuffle, sort-by-target — seeded.

    ``mult_data >= 1`` composes duplicate/shuffle/sort as index operations
    over the untouched row table (compressed form; standardization moments
    are the table's, which equal the duplicated stream's). ``mult_data < 1``
    subsamples rows and materializes directly.

    ``row_ok`` (the quarantine mask of ``io.sanitize``) marks rows left out
    of the stream's statistics but carried positionally: they are
    canonicalized first (``sanitize.mask_rows``: zero features, the
    smallest valid label), left out of the standardization moments, and go
    through the duplicate/shuffle/sort like every other row; the dense
    striper folds the mask into the validity plane.
    """
    rng = np.random.default_rng(seed)
    n = len(y)

    if row_ok is not None:
        row_ok = np.asarray(row_ok, bool)
        if row_ok.shape != (n,):
            raise ValueError(
                f"row_ok shape {row_ok.shape} does not match {n} stream rows"
            )
        if row_ok.all():
            row_ok = None
        else:
            from .sanitize import mask_rows

            X, y = mask_rows(X, y, row_ok)

    def _standardize(A, ok=None):
        A = np.ascontiguousarray(A, np.float32)
        if not standardize:
            return A
        sel = A if ok is None else A[ok]
        mu = sel.mean(axis=0)
        sd = sel.std(axis=0)
        # Constant (or non-finite) columns standardize to 0, not 0/0.
        sd = np.where((sd > 0) & np.isfinite(sd), sd, np.float32(1.0))
        mu = np.where(np.isfinite(mu), mu, np.float32(0.0))
        out = (A - mu) / sd
        if ok is not None:
            out[~ok] = 0.0  # masked rows keep the canonical zero fill
        return out

    if mult_data < 1.0:
        take = rng.permutation(n)[: max(1, int(round(n * mult_data)))]
        X, y = X[take], y[take]
        ok = row_ok[take] if row_ok is not None else None
        order = np.argsort(y, kind="stable")
        X, y = X[order], y[order]
        if ok is not None:
            ok = ok[order]
            if ok.all():
                ok = None
            elif not ok.any():
                raise ValueError(
                    "subsampling left no valid (unmasked) rows in the stream"
                )
        classes, y_idx = np.unique(y, return_inverse=True)
        return StreamData(
            X=_standardize(X, ok),
            y=y_idx.astype(np.int32),
            num_classes=len(classes),
            dist_between_changes=len(y) // len(classes),
            row_ok=ok,
        )

    reps = int(mult_data)
    sel = rng.permutation(n * reps) % n  # each table row exactly `reps` times
    order = np.argsort(y[sel], kind="stable")
    src = sel[order].astype(np.int32)
    classes, y_base = np.unique(y, return_inverse=True)
    return StreamData(
        num_classes=len(classes),
        dist_between_changes=len(src) // len(classes),
        base_X=_standardize(X, row_ok),
        base_y=y_base.astype(np.int32),
        src=src,
        base_ok=row_ok,
    )


def load_stream(
    path: str,
    mult_data: float = 1.0,
    seed: int = 0,
    standardize: bool = True,
    data_policy: str | None = None,
    quarantine_path: str | None = None,
) -> StreamData:
    """Dataset → prepared stream: a CSV file, or a ``synth:`` spec (see
    ``io.synth.parse_synth``).

    ``data_policy`` (None = the trusting :func:`load_csv`) sends a CSV
    through ``io.sanitize.load_csv_sane``: ``'strict'`` raises a
    ``StreamContractError`` on any contract violation, ``'quarantine'``
    masks violating rows and writes them to the ``quarantine_path``
    sidecar, ``'repair'`` imputes what it can and quarantines the rest.
    Synthetic specs are clean by construction and skip validation."""
    row_ok = None
    report = None
    if path.startswith("synth:"):
        from .synth import parse_synth

        X, y = parse_synth(path[len("synth:") :])
    elif data_policy is not None:
        from .sanitize import load_csv_sane

        X, y, row_ok, report = load_csv_sane(
            path, policy=data_policy, quarantine_path=quarantine_path
        )
    else:
        X, y = load_csv(path)
    stream = synthesize_stream(X, y, mult_data, seed, standardize, row_ok=row_ok)
    stream.quarantine = report
    return stream


def _pad(arr: np.ndarray, padded: int, fill) -> np.ndarray:
    out = np.full((padded, *arr.shape[1:]), fill, arr.dtype)
    out[: len(arr)] = arr
    return out


BFLOAT16 = "bfloat16"


def transport_dtype(feature_dtype) -> "np.dtype":
    """The numpy dtype a feature plane ships in: float32, or — for
    ``"bfloat16"``, ``torch.bfloat16`` or a numpy bfloat16 type — uint16
    holding bfloat16 bits (:func:`to_bfloat16_bits`)."""
    if str(feature_dtype) in (BFLOAT16, "torch.bfloat16"):
        return np.dtype(np.uint16)
    dt = np.dtype(feature_dtype)
    return np.dtype(np.uint16) if dt.name == BFLOAT16 else dt


def to_bfloat16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → the uint16 bits of bfloat16, rounded to nearest even as
    ``ml_dtypes`` rounds: a NaN becomes the quiet NaN of its sign (0x7FC0 /
    0xFFC0), everything else ``(bits + 0x7FFF + lsb) >> 16`` in uint32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    lsb = (u >> np.uint32(16)) & np.uint32(1)
    out = ((u + np.uint32(0x7FFF) + lsb) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(np.asarray(x, np.float32))
    if nan.any():
        out[nan] = np.where(u[nan] >> np.uint32(31), 0xFFC0, 0x7FC0).astype(np.uint16)
    return out


def _as_transport(X, dtype: np.dtype) -> np.ndarray:
    """The feature rows in the transport dtype (bfloat16 bits for uint16)."""
    if dtype == np.uint16:
        return to_bfloat16_bits(X)
    return np.asarray(X, dtype)


def stripe_chunk(
    X: np.ndarray,
    y: np.ndarray,
    start_row: int,
    partitions: int,
    per_batch: int,
    nb: int,
    shuffle_seed: int | None = None,
    feature_dtype=np.float32,
    row_valid: np.ndarray | None = None,
) -> Batches:
    """Pad + row-stripe one contiguous span of the stream into ``[P, NB, B]``.

    Row ``start_row + i`` goes to partition ``(start_row + i) % P``;
    ``shuffle_seed`` applies the per-microbatch shuffle on the host
    (counter-based on the absolute batch slot, so chunking is invariant).
    ``feature_dtype`` is the transport dtype of the feature plane: float32
    (exact), or ``"bfloat16"`` (``torch.bfloat16``), which ships a uint16
    plane of bfloat16 bits rounded as ``ml_dtypes`` rounds — half the
    host→device bytes; the engines view it as ``torch.bfloat16`` on the
    device and compute in float32 (:func:`to_bfloat16_bits`).
    ``row_valid`` ([n] bool, the span's quarantine mask) folds into the
    validity plane: a masked row keeps its position, but its slot carries
    the padding fill (features 0.0, label 0) and ``valid == False``.
    """
    n = len(y)
    p, b = partitions, per_batch
    if row_valid is not None:
        row_valid = np.asarray(row_valid, bool)
        if row_valid.shape != (n,):
            raise ValueError(
                f"row_valid shape {row_valid.shape} != span rows ({n},)"
            )
        X = np.where(row_valid[:, None], X, np.asarray(X).dtype.type(0))
        y = np.where(row_valid, y, 0)
    gmap, rows, valid = _stripe_maps(n, start_row, p, b, nb, shuffle_seed)
    if row_valid is not None:
        valid = valid & _pad(row_valid, p * nb * b, False)[gmap]
    return Batches(
        X=_pad(_as_transport(X, transport_dtype(feature_dtype)), p * nb * b, 0)[gmap],
        y=_pad(np.asarray(y, np.int32), p * nb * b, 0)[gmap],
        rows=rows,
        valid=valid,
    )


class ChunkStriper:
    """Allocation-pooled twin of :func:`stripe_chunk` for the chunk feed's
    hot loop (``io.feeder.csv_chunks``): the same placement, shuffle,
    transport dtype and validity folding — bit-identical output — but the
    pad staging buffers are reused across chunks and the gather map is
    cached when the stream is unshuffled (it is start-invariant then).
    One striper belongs to one pipeline stage (not thread-safe); the
    returned planes are fresh gather outputs, so handing them downstream
    while the striper reuses its staging is safe.
    """

    def __init__(self, partitions: int, per_batch: int, chunk_batches: int,
                 shuffle_seed: int | None = None, feature_dtype=np.float32):
        self.p, self.b, self.nb = partitions, per_batch, chunk_batches
        self.shuffle_seed = shuffle_seed
        self.feature_dtype = transport_dtype(feature_dtype)
        self.span = partitions * per_batch * chunk_batches
        self._gmap: np.ndarray | None = None  # unshuffled: start-invariant
        self._padX: np.ndarray | None = None  # [span, F] staging, pooled
        self._pady = np.zeros(self.span, np.int32)

    def _maps(self, n: int, start_row: int):
        """(gmap, rows, valid) — exactly :func:`_stripe_maps`, with the
        unshuffled gather map computed once and reused."""
        if self.shuffle_seed is None:
            if self._gmap is None:
                self._gmap = _stripe_gmap(_stripe_perms(self.p, self.b, self.nb, None))
            gmap = self._gmap
        else:
            assert start_row % (self.p * self.b) == 0, (
                "stripe-time shuffle needs start_row aligned to partitions*per_batch"
            )
            gmap = _stripe_gmap(_stripe_perms(
                self.p, self.b, self.nb, self.shuffle_seed, start_row // (self.p * self.b)
            ))
        return gmap, (start_row + gmap).astype(np.int32), gmap < n

    def stripe(self, X: np.ndarray, y: np.ndarray, start_row: int,
               row_valid: np.ndarray | None = None) -> Batches:
        """One span → ``[P, NB, B]`` chunk; :func:`stripe_chunk` semantics."""
        n = len(y)
        if n > self.span:
            raise ValueError(f"span of {n} rows exceeds chunk grid {self.span}")
        if row_valid is None and n == self.span:
            # A full clean span: no padding, so gather straight from the
            # caller's arrays when they are in the transport dtype already.
            Xa, ya = np.asarray(X), np.asarray(y)
            if Xa.dtype == self.feature_dtype and ya.dtype == np.int32 and Xa.ndim == 2:
                gmap, rows, valid = self._maps(n, start_row)
                return Batches(X=Xa[gmap], y=ya[gmap], rows=rows, valid=valid)
        if row_valid is not None:
            row_valid = np.asarray(row_valid, bool)
            if row_valid.shape != (n,):
                raise ValueError(
                    f"row_valid shape {row_valid.shape} != span rows ({n},)"
                )
            X = np.where(row_valid[:, None], X, np.asarray(X).dtype.type(0))
            y = np.where(row_valid, y, 0)
        gmap, rows, valid = self._maps(n, start_row)
        if row_valid is not None:
            valid = valid & _pad(row_valid, self.span, False)[gmap]
        X = np.asarray(X)
        if self._padX is None or self._padX.shape[1] != X.shape[1]:
            self._padX = np.zeros((self.span, X.shape[1]), self.feature_dtype)
        padX, pady = self._padX, self._pady
        padX[:n] = _as_transport(X, self.feature_dtype)
        padX[n:] = 0
        pady[:n] = np.asarray(y, np.int32)
        pady[n:] = 0
        return Batches(X=padX[gmap], y=pady[gmap], rows=rows, valid=valid)


def _stripe_maps(
    n: int, start_row: int, p: int, b: int, nb: int, shuffle_seed: int | None
):
    """The stripe as a gather: ``striped[p, s, j] = padded[gmap[p, s, j]]``;
    returns ``(gmap, rows, valid)``, each ``[P, NB, B]``."""
    assert shuffle_seed is None or start_row % (p * b) == 0, (
        "stripe-time shuffle needs start_row aligned to partitions*per_batch"
    )
    perms = _stripe_perms(p, b, nb, shuffle_seed, start_row // (p * b))
    gmap = _stripe_gmap(perms)
    rows = (start_row + gmap).astype(np.int32)
    valid = gmap < n
    return gmap, rows, valid


def _stripe_perms(
    p: int, b: int, nb: int, shuffle_seed: int | None, start_slot: int = 0
) -> np.ndarray:
    """Within-batch shuffle permutations ``[P, NB, B]`` (identity when
    unshuffled), counter-based on the absolute batch slot."""
    if shuffle_seed is None:
        j = np.arange(b, dtype=np.int64)
        return np.broadcast_to(j, (p, nb, b))
    from ..utils.prng import row_uniforms

    u = row_uniforms(shuffle_seed, start_slot * p, nb * p, b, stream_id=3)
    return np.argsort(u.reshape(nb, p, b), axis=-1).swapaxes(0, 1)


def _stripe_gmap(perms: np.ndarray) -> np.ndarray:
    """``gmap[p, s, j] = (s·B + perm[p, s, j])·P + p`` — the stripe gather,
    replayed on the device by ``engine.loop.expand_packed``."""
    p, nb, b = perms.shape
    slot = np.arange(nb, dtype=np.int64)[None, :, None]
    part = np.arange(p, dtype=np.int64)[:, None, None]
    return (slot * b + perms) * p + part


def stripe_geometry(
    num_rows: int, partitions: int, per_batch: int
) -> tuple[int, int]:
    """``(rows per partition, microbatches per partition)`` — ceil at both
    levels; the last batch is padded and masked."""
    per_part = -(-num_rows // partitions)
    return per_part, -(-per_part // per_batch)


def stripe_partitions(
    stream: StreamData,
    partitions: int,
    per_batch: int,
    shuffle_seed: int | None = None,
) -> Batches:
    """Row-stripe the whole stream over P partitions: ``X [P, NB, B, F]``,
    ``y/rows/valid [P, NB, B]``; quarantined rows (``stream.row_ok``) fold
    into the validity plane."""
    _, nb = stripe_geometry(stream.num_rows, partitions, per_batch)
    return stripe_chunk(
        stream.X, stream.y, 0, partitions, per_batch, nb, shuffle_seed,
        row_valid=stream.row_ok,
    )


def stripe_partitions_packed(
    stream: StreamData,
    partitions: int,
    per_batch: int,
    shuffle_seed: int | None = None,
) -> PackedIndexedBatches:
    """The compressed stripe: the row table, row-table gather indices
    ``idx [P, NB, B]`` (int16 when the table allows) and the per-batch
    permutation ``perm [P, NB, B]`` in its smallest lossless dtype. Requires
    a stream synthesized with ``mult_data >= 1``."""
    if stream.src is None:
        raise ValueError(
            "stream has no compressed form (subsampled or hand-built); "
            "use stripe_partitions"
        )
    if stream.has_masked_rows:
        # the packed form synthesizes `valid` from the geometry alone
        # (engine.loop.expand_packed); a quarantine mask is data
        raise ValueError(
            "stream has quarantine-masked rows; the packed striper cannot "
            "carry a row mask — use stripe_partitions"
        )
    n = stream.num_rows
    p, b = partitions, per_batch
    _, nb = stripe_geometry(n, p, b)
    if p * nb * b > 2**31 - 1:
        raise ValueError(
            f"padded stripe grid of {p * nb * b:,} positions exceeds int32 "
            "(expand_packed synthesizes positions as int32)"
        )
    perms = _stripe_perms(p, b, nb, shuffle_seed)
    idx = _pad(stream.src.astype(np.int64), p * nb * b, 0)[_stripe_gmap(perms)]
    dt = np.int16 if len(stream.base_y) <= np.iinfo(np.int16).max else np.int32
    if b <= 256:
        pdt = np.uint8
    elif b <= np.iinfo(np.int16).max + 1:
        pdt = np.int16
    else:
        pdt = np.int32
    return PackedIndexedBatches(
        base_X=stream.base_X,
        base_y=stream.base_y,
        idx=idx.astype(dt),
        perm=np.ascontiguousarray(perms.astype(pdt)),
        n_rows=np.int32(n),
    )
