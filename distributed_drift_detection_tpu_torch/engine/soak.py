"""Device-generated soak: the 1e9-row sustained-throughput configuration.

The port's twin of the JAX package's ``engine/soak.py``. Each partition
synthesises its own microbatches on the device — keyed by ``fold_in(key,
batch_index)``, deterministic and replayable — and feeds them straight into
the detection step, so no row crosses from the host during the soak; the
only transfer is the flag table.

Generation is kernel K6 (``csrc/soak_gen.cu``, :func:`soak_batch`): it
writes a batch (or a chunk of batches) straight into the engine's padded
row table ``[P·count·B, row_stride(F)]`` with its labels and global row
positions, a CTA a tile of :data:`K6_TILE` rows that stages its concepts'
prototypes or weights once (:func:`k6_plan`); :func:`soak_batch_reference`
is its plain PyTorch version, on the per-row generators below, which give
the JAX package's bits:

* ``'sea'`` (:func:`_sea_batch`) — features ~ U[0,10)³, label ``f0 + f1 <=
  θ`` with θ cycling through the four SEA thresholds every ``drift_every``
  rows; bit for bit;
* ``'hyperplane'`` (:func:`_hyperplane_batch`) — label = sign of ``w·x −
  0.5·Σw`` with per-concept weights drawn from ``fold_in(key(7), block)``;
  X and w bit for bit, and the margin as XLA's CPU code computes it in the
  generator's program (one rounded product, then fused multiply-adds in
  feature order: ``fma(x0, w0, x1·w1)``, ``fma(x2, w2, ·)``, …);
* ``'hyperplane_gradual'`` — the same with a per-row rotation ``w +
  0.3·sin(2π·(row mod period)/period + f)`` (fused as XLA fuses it), the
  sine XLA's CPU ``sin``, the C library's ``sinf`` (``ops/prefix.py``
  ``xla_sin``, ``csrc/xla_sinf.cuh``); bit for bit;
* ``'prototypes'`` (default, :func:`_prototype_batch`) — Gaussian class
  blobs redrawn every concept: ``y = randint(kc, (B,), 0, 8)``, ``x =
  fma(erf_inv(u_n), f32(√2·0.08), erf_inv(u_p)·f32(√2·3))`` (XLA folds
  both scales into the normals' √2); bit for bit.

Engines (:func:`make_soak_runner`): ``window=1`` is the port's
``engine/loop.py`` step over K6's table with a constant ``idx``; ``window >
1`` the port's window span chunk by chunk, the carry crossing chunks;
``tenants > 1`` the JAX package's key layout. The chained soak
(:func:`make_soak_chain`, :func:`run_soak_chained`) carries the state
across legs with partition-local rows and the concept offsets ``block0s``
as a runtime argument, and checkpoints it (``utils/checkpoint.py``). No
engine reads the device from the host inside its batch loop: the batch
count is known. Entry points run on the card unless ``device='cpu'``.

``mesh`` (a ``parallel.mesh.Mesh``, or ``device`` given as a sequence of
devices) splits the partition plane into the mesh's contiguous shards, as
the JAX package's ``_mesh_sharding`` does: each shard generates its own
partitions' rows with K6 from the whole plane's keys on its device and runs
the engine there; the flags are joined on the first device. A sharded
chain's state is a list of the shards' states.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import DDMParams
from ..device import resolve_device
from ..models.base import Model, row_stride
from ..ops.prefix import f32, fma, xla_sin
from ..utils import threefry
from .loop import (
    FlagRows,
    IndexedBatches,
    LoopCarry,
    device_keys,
    make_partition_step,
    resolve_detector,
)

_SEA_THETAS = (8.0, 9.0, 7.0, 9.5)  # io.synth._SEA_THETAS
_WEIGHT_KEY = 7  # hyperplane weights: fold_in(key(7), block)
_PROTO_KEY = 11  # prototypes: fold_in(key(11), block)
_PROTO_SCALE = 3.0
_PROTO_CLASSES, _PROTO_NOISE = 8, 0.08
_ROTATE_AMPLITUDE = 0.3
_I32_MAX = 2**31 - 1


class SoakResult(NamedTuple):
    flags: FlagRows  # leaves [P, NB-1]
    rows_processed: int  # P * NB * B


def _as_long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def _blocks(rows: torch.Tensor, drift_every: int, block0) -> torch.Tensor:
    """Concept ids ``block0 + rows // drift_every`` (``block0`` broadcast
    over the trailing row axis)."""
    b0 = _as_long(block0, rows.device)
    return (b0[..., None] if b0.dim() else b0) + rows.long() // int(drift_every)


def _sea_batch(key, rows, drift_every, features, block0=0):
    """JAX ``_sea_batch`` for keys ``[..., 2]`` (int64 holding uint32) and
    rows ``[..., B]``: ``X [..., B, 3]`` f32, ``y [..., B]`` i32."""
    b = rows.shape[-1]
    X = threefry.uniform(key, (b, 3)) * 10.0
    theta = torch.tensor(_SEA_THETAS, dtype=torch.float32, device=rows.device)
    theta = theta[_blocks(rows, drift_every, block0) % len(_SEA_THETAS)]
    y = (X[..., 0] + X[..., 1] <= theta).to(torch.int32)
    return X, y


def hyperplane_margin(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum(X·w) − 0.5·sum(w)`` over the last axis as XLA's CPU code forms
    it inside the generator's program: ``fma(x0, w0, x1·w1)``, then a fused
    multiply-add a feature in order; ``sum(w)`` a plain chain of adds."""
    f = X.shape[-1]
    if f == 1:
        acc = X[..., 0] * w[..., 0]
    else:
        acc = fma(X[..., 0], w[..., 0], X[..., 1] * w[..., 1])
    for j in range(2, f):
        acc = fma(X[..., j], w[..., j], acc)
    sw = w[..., 0]
    for j in range(1, f):
        sw = sw + w[..., j]
    return acc - 0.5 * sw


def normal_factor(scale: float) -> float:
    """The factor of a jitted ``scale * normal``: XLA folds the two float32
    constants into ``f32(f32(√2)·f32(scale))``."""
    return f32(f32(math.sqrt(2.0)) * f32(scale))


def rotation_scale(rotate_period: int) -> float:
    """``2π/period`` as XLA folds ``(2π)·(r / period)``: ``r ·
    f32(f32(1/period)·f32(2π))``."""
    return f32(f32(1.0 / int(rotate_period)) * f32(2.0 * math.pi))


def _hyperplane_batch(key, rows, drift_every, features, rotate_period=0, block0=0):
    """JAX ``_hyperplane_batch``: ``X [..., B, F]`` f32, ``y [..., B]``."""
    b, f = rows.shape[-1], int(features)
    kx = threefry.split(key, 2)[..., 0, :]
    X = threefry.uniform(kx, (b, f))
    wkey = threefry.fold_in(_as_long(threefry.key(_WEIGHT_KEY), rows.device),
                            _blocks(rows, drift_every, block0))
    w = threefry.uniform(wkey, (f,))  # [..., B, F]: one draw a concept
    if rotate_period:
        phase = (rows.long() % int(rotate_period)).float() * rotation_scale(rotate_period)
        arg = phase[..., None] + torch.arange(f, dtype=torch.float32, device=rows.device)
        w = fma(xla_sin(arg), _ROTATE_AMPLITUDE, w)
    y = (hyperplane_margin(X, w) > 0).to(torch.int32)
    return X, y


def _hyperplane_gradual_batch(key, rows, drift_every, features, block0=0):
    """One full boundary rotation per concept: gradual within, abrupt
    across (JAX ``_hyperplane_gradual_batch``)."""
    return _hyperplane_batch(
        key, rows, drift_every, features,
        rotate_period=max(int(drift_every), 1), block0=block0,
    )


def _prototype_batch(
    key, rows, drift_every, features, classes=_PROTO_CLASSES, noise=_PROTO_NOISE, block0=0
):
    """JAX ``_prototype_batch``: each row's class prototype is the normals
    of ``fold_in(key(11), block)`` at its class's flat indices, recomputed
    a row."""
    b, f = rows.shape[-1], int(features)
    ks = threefry.split(key, 2)
    kc, kn = ks[..., 0, :], ks[..., 1, :]
    y = threefry.randint(kc, (b,), 0, int(classes))  # [..., B]
    pkey = threefry.fold_in(_as_long(threefry.key(_PROTO_KEY), rows.device),
                            _blocks(rows, drift_every, block0))  # [..., B, 2]
    cols = torch.arange(f, dtype=torch.int64, device=rows.device)
    proto = threefry.normal_erf_inv(threefry.unit_floats(
        threefry.bits_at(pkey, y.long()[..., None] * f + cols)
    )) * normal_factor(_PROTO_SCALE)
    n = threefry.normal_erf_inv(threefry._unit_floats(kn, (b, f)))
    X = fma(n, normal_factor(noise), proto)
    return X, y


# name -> (plain generator, default width, K6's generator id)
_GENERATORS = {
    "sea": (_sea_batch, 3, 0),
    "hyperplane": (_hyperplane_batch, 10, 1),
    "hyperplane_gradual": (_hyperplane_gradual_batch, 10, 2),
    "prototypes": (_prototype_batch, 8, 3),
}


def _generator(name: str):
    try:
        return _GENERATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown generator {name!r}; expected one of {sorted(_GENERATORS)}"
        ) from None


def generated_width(generator: str, features: "int | None") -> int:
    """The width of a generator's rows: SEA's three features, else
    ``features`` (the generator's default when None or 0)."""
    _, default_f, gid = _generator(generator)
    return 3 if gid == 0 else int(features or default_f)


class SoakBatch(NamedTuple):
    """K6's output: ``count`` batches of every partition, partition-major."""

    table: torch.Tensor  # [P·count·B, row_stride(F)] f32, zero past column F
    labels: torch.Tensor  # [P·count·B] i32
    rows: torch.Tensor  # [P, count, B] i32 row positions, −1 past `last`


def soak_batch_reference(
    gen_keys, t0: int, count: int, last: int, row_offs, block0s, *,
    per_batch: int, features: int, drift_every: int, generator: str,
    classes: int = _PROTO_CLASSES, noise: float = _PROTO_NOISE,
) -> SoakBatch:
    """Plain PyTorch version of :func:`soak_batch`, on ``gen_keys``'s device.

    Batch ``t = t0 + c`` (``c < count``) of partition ``p`` is the JAX
    package's ``batch_at(min(t, last))``: generator key ``fold_in(gen_keys[p],
    t')``, rows ``row_offs[p] + t'·B + arange(B)``, concept ids ``block0s[p]
    + rows // drift_every``; its row positions are −1 where ``t > last``
    (a window chunk's clamped tail)."""
    gen, _, gid = _generator(generator)
    dev = gen_keys.device
    p, b, de = gen_keys.shape[0], int(per_batch), int(drift_every)
    f = generated_width(generator, features)
    t = torch.arange(int(t0), int(t0) + int(count), dtype=torch.int64, device=dev)
    te = torch.clamp_max(t, int(last))
    keys = threefry.fold_in(gen_keys.long()[:, None, :], te[None, :])  # [P, count, 2]
    rows = (row_offs.long()[:, None, None] + te[None, :, None] * b
            + torch.arange(b, dtype=torch.int64, device=dev))
    kw = {"classes": classes, "noise": noise} if gid == 3 else {}
    X, y = gen(keys, rows, de, f, block0=block0s.long()[:, None], **kw)
    table = torch.zeros((p * int(count) * b, row_stride(f)), dtype=torch.float32, device=dev)
    table[:, :f] = X.reshape(-1, f)
    valid = (t <= int(last))[None, :, None]
    return SoakBatch(table, y.reshape(-1).to(torch.int32),
                     torch.where(valid, rows, -1).to(torch.int32))


# K6's tile: the rows a CTA generates, one a thread (csrc/soak_gen.cu kTile).
K6_TILE = 256
# The plan's shared-memory budget for a tile's concept tables, in floats
# (16 KB: eight CTAs of an SM hold theirs at once).
K6_STAGE_FLOATS = 4096
# The most dynamic shared memory a CTA takes on an H100 (a forced layout).
K6_MAX_SHARED = 232448


class K6Plan(NamedTuple):
    """Kernel K6's layout at a batch geometry (:func:`k6_plan`)."""

    tiles: int  # CTAs a (partition, batch): ceil(B / K6_TILE)
    ctas: int  # the grid: P · count · tiles
    span: int  # the most concepts one tile's rows can reach
    per_concept: int  # floats of a concept's table: C·F prototypes, F weights, 0 (sea)
    slots: int  # concepts a tile stages in shared memory; 0: each row computes its own
    shared_bytes: int  # a CTA's dynamic shared memory: slots · (8 + 4·per_concept)

    @property
    def layout(self) -> str:
        return "staged" if self.slots else "per-row"


def k6_tile_concepts(row0: int, rows: int, drift_every: int) -> tuple[int, int]:
    """``(first, span)``: the concept offsets ``row0 // drift_every`` ..
    ``(row0 + rows − 1) // drift_every`` that a tile of ``rows`` rows from
    ``row0`` (≥ 0) reaches, as the kernel works them out."""
    first = int(row0) // int(drift_every)
    return first, (int(row0) + int(rows) - 1) // int(drift_every) - first + 1


def k6_max_span(b: int, drift_every: int) -> int:
    """The most concepts a tile's rows reach, over every first row: a tile
    of ``n = min(K6_TILE, B)`` rows starting on a concept's last row."""
    n = min(K6_TILE, int(b))
    return (n + int(drift_every) - 2) // int(drift_every) + 1


@functools.lru_cache(maxsize=256)
def k6_plan(p: int, count: int, b: int, f: int, generator: str, classes: int,
            drift_every: int, force: int = 0) -> K6Plan:
    """K6's layout, a function of the geometry alone (no offsets: the span
    is the worst case over every row a tile may start at, so it holds for
    any ``row_offs``, window tail or chain leg). ``force``: 0 the plan's
    choice, 1 every row computes its table entries, 2 staged wherever a
    concept's table fits a CTA's shared memory (else ``ValueError``).

    The plan stages a tile's concept tables when all ``span`` of them fit
    :data:`K6_STAGE_FLOATS` and, for the prototypes, cost no more normals
    than the tile's rows would draw inline (``span · C ≤ rows``). SEA draws
    nothing a concept shares: one layout."""
    if force not in (0, 1, 2):
        raise ValueError(f"k6_plan: force must be 0, 1 or 2, got {force}")
    gid = _generator(generator)[2]
    f = generated_width(generator, f)
    tiles = -(-int(b) // K6_TILE)
    span = k6_max_span(b, drift_every)
    per = 0 if gid == 0 else int(classes) * f if gid == 3 else f
    slots = 0
    if per and force == 2:
        slots = min(span, K6_MAX_SHARED // (8 + 4 * per))
        if not slots:
            raise ValueError(
                f"k6_plan: a concept's table ({per} floats) does not fit a CTA's shared memory"
            )
    elif per and force == 0 and span * per <= K6_STAGE_FLOATS and (
            gid != 3 or span * int(classes) <= min(K6_TILE, int(b))):
        slots = span
    return K6Plan(tiles, int(p) * int(count) * tiles, span, per, slots, slots * (8 + 4 * per))


def _check_soak_inputs(gen_keys, row_offs, block0s):
    dev = gen_keys.device
    p = gen_keys.shape[0]
    for name, t, shape in (("gen_keys", gen_keys, (p, 2)), ("row_offs", row_offs, (p,)),
                           ("block0s", block0s, (p,))):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(
                f"soak_batch: {name} must be int32 {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"soak_batch: {name} must be contiguous")


def soak_batch(
    gen_keys, t0: int, count: int, last: int, row_offs, block0s, *,
    per_batch: int, features: int, drift_every: int, generator: str,
    classes: int = _PROTO_CLASSES, noise: float = _PROTO_NOISE, out: "SoakBatch | None" = None,
    force: int = 0,
) -> SoakBatch:
    """``count`` generated batches of every partition (contract of
    :func:`soak_batch_reference`), written into ``out`` when given.

    ``gen_keys [P, 2]`` (int32 bit patterns of the uint32 key words),
    ``row_offs [P]`` and ``block0s [P]`` int32. CUDA tensors launch kernel
    K6 (``csrc/soak_gen.cu``) in the layout of :func:`k6_plan` (``force``
    its argument), record it as ``soak_batch.plan`` and add one to
    ``soak_batch.launches``; CPU tensors run the plain version."""
    if gen_keys.device.type == "cpu":
        got = soak_batch_reference(
            gen_keys, t0, count, last, row_offs, block0s, per_batch=per_batch,
            features=features, drift_every=drift_every, generator=generator,
            classes=classes, noise=noise,
        )
        if out is None:
            return got
        for dst, src in zip(out, got):
            dst.copy_(src)
        return out
    if gen_keys.device.type != "cuda":
        raise ValueError(f"soak_batch: unsupported device {gen_keys.device}")
    from .. import kernels

    _, _, gid = _generator(generator)
    _check_soak_inputs(gen_keys, row_offs, block0s)
    dev = gen_keys.device
    p, b, f = gen_keys.shape[0], int(per_batch), generated_width(generator, features)
    n = p * int(count) * b
    if not (0 < b and 0 < int(count) and n < 2**31 and 0 <= int(t0)
            and int(t0) + int(count) <= 2**31 and 0 <= int(last) < 2**31
            and 0 < int(drift_every) and 0 < int(classes) < 2**31):
        raise ValueError(
            f"soak_batch: out of range (P={p}, count={count}, B={b}, t0={t0}, "
            f"last={last}, drift_every={drift_every}, classes={classes})"
        )
    if out is None:
        out = SoakBatch(
            torch.empty((n, row_stride(f)), dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty((p, int(count), b), dtype=torch.int32, device=dev),
        )
    elif (tuple(out.table.shape) != (n, row_stride(f)) or tuple(out.labels.shape) != (n,)
          or tuple(out.rows.shape) != (p, int(count), b)
          or not all(t.is_contiguous() and t.device == dev for t in out)):
        raise ValueError("soak_batch: out does not match the batch geometry")
    if out.table.data_ptr() % 16:
        raise ValueError("soak_batch: out.table must be 16-byte aligned (float4 rows)")
    plan = k6_plan(p, int(count), b, f, generator, int(classes), int(drift_every), int(force))
    code = kernels.launcher("soak_batch")(
        *soak_batch_args(gen_keys, t0, count, last, row_offs, block0s, out, per_batch=b,
                         features=f, drift_every=drift_every, generator=gid,
                         classes=classes, noise=noise, slots=plan.slots),
        kernels.stream_handle(dev),
    )
    kernels.check("soak_batch", code)
    soak_batch.plan = plan
    soak_batch.launches += 1
    return out


soak_batch.launches = 0
soak_batch.plan = None


def soak_batch_args(gen_keys, t0, count, last, row_offs, block0s, out, *, per_batch,
                    features, drift_every, generator: int, classes, noise, slots: int):
    """Kernel K6's launch arguments, stream excluded (``generator`` is the
    generator's id, ``features`` the generated width, ``slots`` the plan's
    :attr:`K6Plan.slots`)."""
    rp = max(int(drift_every), 1) if generator == 2 else 0
    return (
        gen_keys.data_ptr(), row_offs.data_ptr(), block0s.data_ptr(),
        gen_keys.shape[0], int(count), int(per_batch), int(features),
        int(t0), int(last), int(drift_every), int(generator), int(classes),
        normal_factor(noise), normal_factor(_PROTO_SCALE),
        rp, rotation_scale(rp) if rp else 0.0, int(slots),
        out.table.data_ptr(), out.labels.data_ptr(), out.rows.data_ptr(),
    )


def resolve_soak_detector(ddm_params: DDMParams, detector, drift_every: int):
    """Detector for a soak engine: a kernel passes through (``None`` → DDM);
    a **name** is built here, with Page–Hinkley's ``threshold = 0`` auto
    sentinel resolved from the soak's own ``drift_every`` — the
    per-partition concept length ``config.auto_ph_threshold`` derives for
    api streams (JAX ``resolve_soak_detector``)."""
    if isinstance(detector, str):
        from ..config import PHParams, auto_ph_threshold_rows
        from ..ops.detectors import make_detector

        ph = PHParams()
        if detector == "ph":
            ph = ph._replace(threshold=auto_ph_threshold_rows(float(drift_every)))
        return make_detector(detector, ddm=ddm_params, ph=ph)
    return resolve_detector(ddm_params, detector)


def _mesh_shards(model: Model, mesh, device, rows: int):
    """``(mesh, [(lo, hi, device)])`` of a soak's ``rows``-wide plane (JAX
    ``_mesh_sharding``): the mesh's shards, checked (divisibility, no
    host-callback model); a sequence of devices makes the mesh ``run``
    makes of them (``parallel.mesh.resolve_mesh``); without a mesh one
    shard of every row on ``device``."""
    from ..device import is_device_sequence, resolve_devices

    if mesh is None and is_device_sequence(device):
        from ..parallel.mesh import resolve_mesh

        devices = resolve_devices(device)
        mesh = resolve_mesh(devices, rows, model=model)
        device = devices[0]
    if mesh is None:
        return None, [(0, rows, resolve_device(device))]
    from ..models.base import require_shardable
    from ..parallel.mesh import shard_bounds

    require_shardable(model, mesh)
    return mesh, [(lo, hi, d) for _, lo, hi, d in shard_bounds(mesh, rows)]


class _Feed:
    """K6 writing ``count`` batches a call into buffers it keeps: the
    partitions' generator keys, row offsets and concept offsets on the
    device, the batch clamp ``last``."""

    def __init__(self, gen_keys: np.ndarray, row_offs, block0s, count: int, last: int,
                 *, per_batch, features, drift_every, generator, device):
        self.keys = device_keys(gen_keys, device)
        self.row_offs = torch.as_tensor(row_offs, dtype=torch.int32, device=device).contiguous()
        self.block0s = torch.as_tensor(block0s, dtype=torch.int32, device=device).contiguous()
        self.count, self.last = int(count), int(last)
        self.kw = dict(per_batch=per_batch, features=features, drift_every=drift_every,
                       generator=generator)
        self.out = None

    def __call__(self, t0: int) -> SoakBatch:
        self.out = soak_batch(self.keys, t0, self.count, self.last, self.row_offs,
                              self.block0s, out=self.out, **self.kw)
        return self.out


def _seed_carry(model: Model, det, feed: _Feed, keys: np.ndarray, dev) -> LoopCarry:
    """Batch 0 seeds ``batch_a``; params from ``init(split(key)[1])``; the
    loop key is the partition's key itself (JAX ``run_partition``)."""
    p, b = keys.shape[0], feed.kw["per_batch"]
    first = feed(0)
    f = generated_width(feed.kw["generator"], feed.kw["features"])
    init_key = device_keys(threefry.split(keys, 2)[:, 1], dev) if model.keyed else None
    return LoopCarry(
        params=model.init(p, dev, key=init_key),
        ddm=det.init((p,), dev),
        a_X=first.table.view(p, b, -1)[:, :, :f].clone(memory_format=torch.contiguous_format),
        a_y=first.labels.view(p, b).clone(),
        a_w=torch.ones((p, b), dtype=torch.float32, device=dev),
        retrain=torch.ones(p, dtype=torch.bool, device=dev),
        key=keys if model.keyed else None,
    )


def _run_steps(step, model: Model, carry: LoopCarry, feed: _Feed, ts: range):
    """The sequential engine over batches ``ts``: generate, step. Returns
    the carry and the flag leaves ``[P, len(ts)]`` (no host read inside)."""
    p, b = carry.a_X.shape[:2]
    dev = carry.a_X.device
    idx = torch.arange(p * b, dtype=torch.int32, device=dev).view(p, b)
    valid = torch.ones((p, b), dtype=torch.bool, device=dev)
    chain = fit_keys = None
    if model.keyed:
        chain, fit_keys = threefry.loop_fit_keys(carry.key, len(ts))
        fit_keys = device_keys(fit_keys, dev)
    out = []
    for s, t in enumerate(ts):
        got = feed(t)
        keys = None if chain is None else (chain[s + 1], fit_keys[s])
        carry, flags = step(carry, got.table, got.labels, idx, got.rows[:, 0], valid, keys)
        out.append(flags)
    if not out:
        empty = torch.empty((p, 0), dtype=torch.int32, device=dev)
        return carry, FlagRows(empty, empty, empty, empty, empty.bool())
    return carry, FlagRows(*(torch.stack(leaf, 1) for leaf in zip(*out)))


def _partition_keys(key, p: int, tenants: int) -> tuple:
    """The partitions' keys ``[T·P, 2]`` and their partition indices: tenant
    ``t``'s block is a solo run keyed by ``split(key, T)[t]``."""
    key = np.asarray(key, np.uint32)
    if tenants == 1:
        return threefry.split(key, p), np.arange(p)
    tkeys = threefry.split(key, tenants)
    return threefry.split(tkeys, p).reshape(tenants * p, 2), np.tile(np.arange(p), tenants)


def make_soak_runner(
    model: Model,
    ddm_params: DDMParams = DDMParams(),
    *,
    partitions: int,
    per_batch: int,
    num_batches: int,
    drift_every: int,
    generator: str = "prototypes",
    features: int | None = None,
    mesh=None,
    detector=None,
    window: int = 1,
    chunk_batches: int = 0,
    rotations: int = 1,
    tenants: int = 1,
    device="cuda",
):
    """Build ``run(key) -> SoakResult``: the whole soak on ``device``.

    ``key`` is a threefry key's data (``utils.threefry.key(seed)``). Each
    partition runs an independent ``num_batches``-long stream; flags come
    back as ``[P, NB-1]`` tensors on the device (batch 0 seeds
    ``batch_a``). ``window > 1`` runs the window span over device-generated
    chunks of ``chunk_batches`` batches (default ``2·window``), the carry
    crossing chunks; batches past ``NB-1`` in the last chunk are generated
    at ``NB-1``, invalid and inert. ``tenants > 1`` widens the plane to
    ``T·P`` streams; tenant ``t``'s block is the solo run keyed by
    ``split(key, T)[t]``. ``mesh`` shards the ``T·P`` plane."""
    gen_name = generator
    _generator(gen_name)
    f = generated_width(gen_name, features)
    b, nb, p = int(per_batch), int(num_batches), int(partitions)
    if p * nb * b > _I32_MAX:
        raise ValueError(
            f"soak of {p * nb * b:,} rows exceeds the int32 global-row-index "
            "range (2^31-1); use run_soak_chained / make_soak_chain"
        )
    det = resolve_soak_detector(ddm_params, detector, drift_every)
    if window < 1:
        raise ValueError(
            "window must be >= 1 for the soak engine (0 = auto is resolved "
            "by config.auto_window; pass an explicit width here)"
        )
    if chunk_batches < 0:
        raise ValueError(
            f"chunk_batches must be >= 0 (0 = auto), got {chunk_batches}"
        )
    if chunk_batches and window <= 1:
        raise ValueError(
            "chunk_batches only applies to the windowed soak (window > 1); "
            "the sequential scan does not chunk"
        )
    if window <= 1 and rotations != 1:
        raise ValueError(
            "rotations only applies to the window engine (window > 1)"
        )
    if window > 1:
        from .window import make_window_span

        span = make_window_span(model, ddm_params, window=window, detector=det,
                                rotations=rotations)
        cb = int(chunk_batches) or 2 * int(window)
    else:
        step = make_partition_step(model, ddm_params, shuffle=False, detector=det)
    if tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    t_count = int(tenants)
    mesh, shards = _mesh_shards(model, mesh, device, t_count * p)
    dev = shards[0][2]

    def run(key) -> SoakResult:
        from ..parallel.mesh import join_flags, run_shards

        keys, parts = _partition_keys(key, p, t_count)
        devs = [d for _, _, d in shards]
        outs = run_shards(devs, run_rows, [keys[lo:hi] for lo, hi, _ in shards],
                          [parts[lo:hi] for lo, hi, _ in shards], devs)
        return SoakResult(join_flags(outs, dev), t_count * p * nb * b)

    def run_rows(keys, parts, dev) -> FlagRows:
        """The soak of the partitions ``parts`` (keys ``keys``) on ``dev``."""
        gen_kw = dict(per_batch=b, features=f, drift_every=drift_every, generator=gen_name,
                      device=dev)
        gen_keys = threefry.split(keys, 2)[:, 0]
        offs, zero = parts * (nb * b), np.zeros(len(parts), np.int64)
        if window <= 1:
            feed = _Feed(gen_keys, offs, zero, 1, nb - 1, **gen_kw)
            carry = _seed_carry(model, det, feed, keys, dev)
            _, flags = _run_steps(step, model, carry, feed, range(1, nb))
            return flags
        carry = _seed_carry(model, det, _Feed(gen_keys, offs, zero, 1, nb - 1, **gen_kw),
                            keys, dev)
        feed = _Feed(gen_keys, offs, zero, cb, nb - 1, **gen_kw)
        q = len(parts)
        idx = torch.arange(q * cb * b, dtype=torch.int32, device=dev).view(q, cb, b)
        nbf = nb - 1
        parts_out = []
        for ci in range(-(-nbf // cb)):
            got = feed(1 + ci * cb)
            carry, fl = span(carry, IndexedBatches(
                base_X=got.table[:, :f], base_y=got.labels, idx=idx, rows=got.rows,
                valid=got.rows >= 0,
            ))
            parts_out.append(fl)
        if not parts_out:
            empty = torch.empty((q, 0), dtype=torch.int32, device=dev)
            return FlagRows(empty, empty, empty, empty, empty.bool())
        return FlagRows(*(torch.cat(leaf, 1)[:, :nbf] for leaf in zip(*parts_out)))

    return run


# --------------------------------------------------------------------------
# Chained soak: beyond the int32 row-index ceiling with exact semantics
# --------------------------------------------------------------------------


class SoakChainState(NamedTuple):
    """Cross-leg carry of the chained soak: the :class:`LoopCarry` (leading
    ``[P]``; a keyed model's loop key as uint32 ``[P, 2]`` on the host) and
    the partitions' generator keys ``[P, 2]`` uint32, kept apart from the
    loop key because the generator stays replayable from the absolute batch
    index."""

    carry: LoopCarry
    gen_keys: np.ndarray  # [P, 2] uint32


class SoakLegFlags(NamedTuple):
    state: SoakChainState
    flags: FlagRows  # [P, L] (leg 0: [P, L-1] — batch 0 seeds batch_a)


class _SoakChainImpl(NamedTuple):
    """The chain's legs with the block-offset vector as a runtime argument."""

    first: object  # (key, block0s) -> SoakLegFlags
    next: object  # (state, leg_idx, block0s) -> SoakLegFlags
    block0s: torch.Tensor  # [P] i32 on the (first) device
    # () -> a zero state of the chain's shapes (a SoakChainState; on a mesh
    # a list of the shards')
    template: object


def _make_soak_chain_impl(
    model: Model,
    ddm_params: DDMParams = DDMParams(),
    *,
    partitions: int,
    per_batch: int,
    batches_per_leg: int,
    legs: int,
    drift_every: int,
    generator: str = "prototypes",
    features: int | None = None,
    detector=None,
    mesh=None,
    donate: bool = False,
    device="cuda",
):
    """Build the state-carrying chained soak (JAX ``_make_soak_chain_impl``):
    ``legs`` legs of ``batches_per_leg`` batches, the whole detection state
    carried across them. Rows are partition-local positions (``<
    legs·batches_per_leg·per_batch``, which must fit int32); the generator
    gets the partition's concept offset as ``block0s[p]``, so concepts and
    boundaries are those of the unchained stream. The concatenated flags
    equal :func:`make_soak_runner`'s, modulo the partition row offset.
    ``donate`` is accepted: each leg consumes its input state, which the
    port never copies. On a ``mesh`` the state is a list of the shards'
    states, each on its device."""
    gen_name = generator
    _generator(gen_name)
    f = generated_width(gen_name, features)
    b, L, p, S = int(per_batch), int(batches_per_leg), int(partitions), int(legs)
    de = int(drift_every)
    if L * b % de:
        raise ValueError(
            f"leg length {L}·{b} rows must be a multiple of drift_every={de} "
            "(keeps concept ids, delay arithmetic and rotation phase exact "
            "across leg boundaries)"
        )
    t_pp = S * L * b  # per-partition stream length
    if t_pp > _I32_MAX:
        raise ValueError(
            f"per-partition stream of {t_pp:,} rows exceeds int32 positions; "
            "raise `partitions` (the ceiling scales with it)"
        )
    total_blocks = p * (t_pp // de)
    if total_blocks > _I32_MAX:
        raise ValueError(
            f"{total_blocks:,} total concept blocks exceed int32 ids; "
            "raise `drift_every` or lower `partitions`"
        )
    det = resolve_soak_detector(ddm_params, detector, drift_every)
    step = make_partition_step(model, ddm_params, shuffle=False, detector=det)
    mesh, shards = _mesh_shards(model, mesh, device, p)
    dev = shards[0][2]
    blocks_pp = t_pp // de
    block0s = torch.arange(p, dtype=torch.int32, device=dev) * blocks_pp

    def feed_of(gen_keys, block0s: torch.Tensor, d) -> _Feed:
        return _Feed(gen_keys, np.zeros(len(gen_keys), np.int64), block0s, 1, _I32_MAX,
                     per_batch=b, features=f, drift_every=de, generator=gen_name, device=d)

    def first_rows(keys, block0s: torch.Tensor, d) -> SoakLegFlags:
        gen_keys = threefry.split(keys, 2)[:, 0]
        feed = feed_of(gen_keys, block0s, d)
        carry = _seed_carry(model, det, feed, keys, d)
        carry, flags = _run_steps(step, model, carry, feed, range(1, L))
        return SoakLegFlags(SoakChainState(carry, gen_keys), flags)

    def next_rows(state: SoakChainState, leg_idx, block0s: torch.Tensor, d) -> SoakLegFlags:
        t0 = int(leg_idx) * L
        feed = feed_of(state.gen_keys, block0s, d)
        carry, flags = _run_steps(step, model, state.carry, feed, range(t0, t0 + L))
        return SoakLegFlags(SoakChainState(carry, state.gen_keys), flags)

    def template_rows(n: int, d) -> SoakChainState:
        key0 = device_keys(np.zeros((n, 2), np.uint32), d) if model.keyed else None
        return SoakChainState(
            LoopCarry(
                params=model.init(n, d, key=key0),
                ddm=det.init((n,), d),
                a_X=torch.zeros((n, b, f), dtype=torch.float32, device=d),
                a_y=torch.zeros((n, b), dtype=torch.int32, device=d),
                a_w=torch.zeros((n, b), dtype=torch.float32, device=d),
                retrain=torch.zeros(n, dtype=torch.bool, device=d),
                key=np.zeros((n, 2), np.uint32) if model.keyed else None,
            ),
            np.zeros((n, 2), np.uint32),
        )

    def sharded(fn, states, block0s: torch.Tensor) -> SoakLegFlags:
        """``fn(state, lo, hi, the shard's block0s, device)`` a shard: the
        leg's state (a list on a mesh) and its joined flags."""
        from ..parallel.mesh import join_flags, run_shards

        outs = run_shards(
            [d for _, _, d in shards],
            lambda st, lo, hi, d: fn(st, lo, hi, block0s[lo:hi].to(d), d),
            states, *zip(*shards),
        )
        if mesh is None:
            return outs[0]
        return SoakLegFlags([o.state for o in outs], join_flags([o.flags for o in outs], dev))

    def first_leg_impl(key, block0s: torch.Tensor) -> SoakLegFlags:
        keys = threefry.split(np.asarray(key, np.uint32), p)
        return sharded(lambda _, lo, hi, b0, d: first_rows(keys[lo:hi], b0, d),
                       [None] * len(shards), block0s)

    def next_leg_impl(state, leg_idx, block0s: torch.Tensor) -> SoakLegFlags:
        return sharded(lambda st, lo, hi, b0, d: next_rows(st, leg_idx, b0, d),
                       [state] if mesh is None else state, block0s)

    def template():
        if mesh is None:
            return template_rows(p, dev)
        return [template_rows(hi - lo, d) for lo, hi, d in shards]

    return _SoakChainImpl(first_leg_impl, next_leg_impl, block0s, template)


def make_soak_chain(*args, **kwargs):
    """Public form of :func:`_make_soak_chain_impl`: ``(first_leg,
    next_leg)`` with the block offsets bound — ``first_leg(key)``,
    ``next_leg(state, leg_idx)``."""
    impl = _make_soak_chain_impl(*args, **kwargs)

    def first_leg(key) -> SoakLegFlags:
        return impl.first(key, impl.block0s)

    def next_leg(state: SoakChainState, leg_idx) -> SoakLegFlags:
        return impl.next(state, int(leg_idx), impl.block0s)

    return first_leg, next_leg


def _key_fingerprint(key) -> str:
    """Stable hex fingerprint of a key's data (checkpoint geometry field):
    the JAX package's, for the same key data."""
    import hashlib

    data = np.asarray(key, np.uint32)
    return hashlib.sha256(data.tobytes() + str(data.shape).encode()).hexdigest()[:16]


def planted_interior_boundaries(
    partitions: int, rows_per_partition: int, drift_every: int
) -> int:
    """Exact count of detectable planted boundaries across the soak:
    partition ``q`` covers global rows ``[q·R, (q+1)·R)``, and a boundary at
    ``m·drift_every`` is detectable only strictly inside that range."""
    r, de = int(rows_per_partition), int(drift_every)
    return sum(
        ((q + 1) * r - 1) // de - (q * r) // de for q in range(int(partitions))
    )


class ChainedSoakSummary(NamedTuple):
    rows_processed: int  # p · legs · batches_per_leg · per_batch (executed)
    legs: int
    detections: int
    delays: "object"  # np.ndarray i64: position % drift_every per detection
    planted_boundaries: int  # detectable (strictly-interior) boundaries
    exec_time_s: float  # execution span only (kernels built before it)
    # The caller's total_rows before rounding up to whole aligned legs.
    requested_rows: int = 0


def soak_kernels(model: Model, detector) -> list:
    """The hand-written kernels a soak of ``model`` and ``detector`` launches."""
    from ..api import kernel_names

    return ["soak_batch"] + kernel_names(model.name, detector.name)


def run_soak_chained(
    model: Model,
    ddm_params: DDMParams = DDMParams(),
    *,
    partitions: int,
    per_batch: int,
    total_rows: int,
    drift_every: int,
    max_leg_rows: int = 2**30,
    generator: str = "prototypes",
    features: int | None = None,
    detector=None,
    mesh=None,
    key=None,
    on_leg=None,
    checkpoint_path: str = "",
    telemetry=None,
    metrics=None,
    donate: bool = True,
    collect_every: int = 1,
    compile_cache_dir: str = "",
    device="cuda",
) -> ChainedSoakSummary:
    """Host driver over :func:`make_soak_chain` (JAX ``run_soak_chained``):
    run at least ``total_rows`` rows in legs of at most ``max_leg_rows``
    (rounded to the drift alignment, the total rounded up to whole legs),
    folding each leg's flags into detection statistics on the host.

    ``key`` is a threefry key's data (default ``threefry.key(0)``). The
    kernels are built (into ``compile_cache_dir``, ``kernels._build``)
    before ``exec_time_s`` starts. ``on_leg(leg_idx, flags)`` observes each
    leg (``change_global`` host-converted). ``checkpoint_path`` saves the
    chain state and statistics atomically after every group of legs; a
    rerun with the same geometry (leg sizing, generator, drift spacing,
    detector name and parameters, key fingerprint) resumes at the first
    unfinished leg and returns the uninterrupted run's summary, a mismatch
    raises. ``telemetry`` (an ``EventLog``) gets ``leg_completed`` and
    ``heartbeat`` a leg; ``metrics`` the device memory gauges a leg.
    ``collect_every`` folds (and syncs, observes, checkpoints) every N-th
    leg. The ``soak.leg`` fault site fires before each leg. ``donate`` is
    accepted (the port never copies a leg's state). ``mesh`` (or ``device``
    as a sequence of devices) shards the partitions; the checkpoint then
    holds the shards' states in shard order."""
    import os
    import time

    from ..kernels import _build
    from ..utils.checkpoint import load_checkpoint, save_checkpoint

    mesh, shards = _mesh_shards(model, mesh, device, int(partitions))
    dev = shards[0][2]
    if compile_cache_dir:
        _build.set_build_dir(compile_cache_dir)
    b, p, de = int(per_batch), int(partitions), int(drift_every)
    detector = resolve_soak_detector(ddm_params, detector, de)
    align_b = de // math.gcd(de, b)
    nb_total = max(-(-int(total_rows) // (p * b)), 2)
    L = max(int(max_leg_rows) // (p * b), align_b)
    L -= L % align_b
    L = min(L, -(-nb_total // align_b) * align_b)
    S = max(-(-nb_total // L), 1)

    impl = _make_soak_chain_impl(
        model, ddm_params, partitions=p, per_batch=b, batches_per_leg=L, legs=S,
        drift_every=de, generator=generator, features=features, detector=detector,
        mesh=mesh, donate=donate, device=dev,
    )
    if key is None:
        key = threefry.key(0)
    if dev.type == "cuda":
        _build.build_all(soak_kernels(model, detector))

    geometry = {
        "p": p, "b": b, "L": L, "S": S, "de": de,
        "generator": generator,
        "detector": detector.name,
        "detector_params": [float(v) for v in detector.params],
        "key_fp": _key_fingerprint(key),
    }
    detections, delays, start_leg, state = 0, [], 0, None
    if checkpoint_path and os.path.exists(checkpoint_path):
        state, meta = load_checkpoint(checkpoint_path, impl.template())
        got = {k: meta.get(k) for k in geometry}
        # An eddm checkpoint recording the 3-float tuple of before EDDMParams
        # grew `paper_exact` is the same chain when the run keeps its default.
        if (
            geometry["detector"] == "eddm"
            and got.get("detector_params") == geometry["detector_params"][:3]
            and geometry["detector_params"][3:] == [0.0]
        ):
            got["detector_params"] = geometry["detector_params"]
        if got != geometry:
            non_key = {k: v for k, v in got.items() if k != "key_fp"}
            if non_key == {
                k: v for k, v in geometry.items() if k != "key_fp"
            } and got.get("key_fp") is None:
                raise ValueError(
                    f"checkpoint {checkpoint_path} predates the PRNG-key "
                    "fingerprint field and cannot be verified against this "
                    "run's key; delete it to restart the chain"
                )
            raise ValueError(
                f"checkpoint {checkpoint_path} was written by a different "
                f"chain geometry ({got} != {geometry}); delete it or match "
                "the original configuration"
            )
        start_leg = int(meta["next_leg"])
        detections = int(meta["detections"])
        if meta["delays"]:
            delays.append(np.asarray(meta["delays"], np.int64))

    from ..resilience import faults

    start = time.perf_counter()
    hb_start = time.monotonic()
    out = None
    group = max(int(collect_every), 1)
    pending: list = []

    def _fold_pending():
        """Group-boundary host work, in leg order: the drive loop's only
        reads of the device."""
        nonlocal detections
        for ls, lo in pending:
            cg = lo.flags.change_global.cpu().numpy()
            hit = cg[cg >= 0]
            detections += int(hit.size)
            if hit.size:
                delays.append(hit.astype(np.int64) % de)
            # the observer before the checkpoint: at-least-once delivery
            if on_leg is not None:
                on_leg(ls, lo.flags._replace(change_global=cg))
            if telemetry is not None:
                telemetry.emit(
                    "leg_completed", leg=ls, rows=p * L * b, detections=int(hit.size),
                )
                telemetry.emit(
                    "heartbeat",
                    rows_done=(ls + 1) * p * L * b,
                    elapsed_s=time.monotonic() - hb_start,
                    leg=ls,
                )
            if metrics is not None:
                from ..telemetry.profile import (
                    device_memory_stats,
                    record_device_memory_gauges,
                )

                record_device_memory_gauges(metrics, device_memory_stats(dev), when="leg")
        pending.clear()

    for s in range(start_leg, S):
        faults.fire("soak.leg", leg=s)
        if s == 0:
            out = impl.first(key, impl.block0s)
        else:
            out = impl.next(state if out is None else out.state, s, impl.block0s)
        pending.append((s, out))
        if len(pending) < group and s != S - 1:
            continue
        _fold_pending()
        if checkpoint_path:
            save_checkpoint(
                checkpoint_path,
                out.state,
                meta={
                    **geometry,
                    "next_leg": s + 1,
                    "detections": detections,
                    "delays": np.concatenate(delays).tolist() if delays else [],
                },
            )
    exec_time = time.perf_counter() - start
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)

    t_pp = S * L * b
    return ChainedSoakSummary(
        rows_processed=p * t_pp,
        legs=S,
        detections=detections,
        delays=np.concatenate(delays) if delays else np.empty(0, np.int64),
        planted_boundaries=planted_interior_boundaries(p, t_pp, de),
        exec_time_s=exec_time,
        requested_rows=int(total_rows),
    )
