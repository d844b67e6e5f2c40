"""Partition parallelism over a device mesh: the port's twin of the JAX
package's ``parallel/mesh.py``.

JAX splits one vmapped program over devices with ``NamedSharding``; the
partitions never talk to each other during the stream, and the only
cross-device work is the end-of-run drift vote and the flag gather. The
port does the same explicitly:

* a :class:`Mesh` is an ordered array of ``torch.device`` shaped ``[n]``
  (axis ``partitions``) or ``[tenant_devices, n / tenant_devices]`` (axes
  ``tenants``, ``partitions``); a device may repeat (``["cpu"] * 8``, or
  ``["cuda:0"] * 4``: four shards on one card);
* the plane axis (a solo run's partitions, or the stacked ``tenant ·
  partition`` rows) is split into ``n`` contiguous equal shards in device
  order — the flattened, tenant-major split of JAX's ``plane_sharding`` —
  and shard ``s`` runs the single-device runner over its rows on device
  ``s``;
* the merge (:func:`merge_shards`, JAX ``finish_mesh_run``): the drift vote
  sums the shards' per-step counts of changed partitions and divides once by
  the plane's rows in float32; the packed plane is the shards' planes in
  partition order on the mesh's first device; each shard compacts its own
  flags with kernel K4 (:func:`compact_flag_table`) at the global capacity,
  its partition column offset by its first row, and
  :func:`merge_compact_tables` keeps the shards' entries in shard order —
  byte for byte the compaction of the whole plane. Across processes
  (``parallel/multihost.py``) the counts are summed and the tables gathered
  over ``torch.distributed``; each process keeps its own rows of the plane.

The sharding-rule twins (:func:`match_partition_rules`,
:func:`plane_rules`, :func:`plane_shardings`) give, for each leaf of a
tree, the placement the port acts on: :class:`NamedSharding` with a spec
that splits the leading axis, or ``P()``, which replicates. A shared input
(the packed stream's row table) is copied once per distinct device.

Without a mesh a runner is the one-device runner of before: the window
engine over the ``[P]`` partition axis, the drift vote, the packed plane
and — for ``collect='compact'`` — the compacted table, so the collect phase
copies O(detections) bytes to the host.
"""

from __future__ import annotations

import contextlib
import re
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..config import DDMParams
from ..engine.loop import Batches, FlagRows, PackedIndexedBatches, expand_packed
from ..models.base import Model

PARTITION_AXIS = "partitions"
# Second axis of a 2-D (tenants, partitions) mesh: whole tenants land on
# tenant-axis rows; the flattened leading axis splits tenant-major.
TENANT_AXIS = "tenants"


class Mesh:
    """An ordered array of devices with named axes (JAX's ``Mesh``).

    ``devices`` is an object array of ``torch.device`` of the mesh's shape;
    ``process_index`` the process that owns each position (all 0 in one
    process), and ``process`` this process's index, so a mesh that spans
    processes (``multihost.global_mesh``) knows which shards are its own."""

    def __init__(self, devices, axis_names, process_index=None, process: int = 0):
        arr = np.empty(len(devices), dtype=object)
        for i, d in enumerate(devices):
            arr[i] = torch.device(d)
        self.axis_names = tuple(axis_names)
        self._flat = arr
        self.devices = arr
        self.process_index = (
            np.zeros(len(devices), np.int64)
            if process_index is None
            else np.asarray(process_index, np.int64).reshape(-1)
        )
        self.process = int(process)

    def reshape(self, *shape) -> "Mesh":
        """The mesh with its devices array reshaped (the flat order kept)."""
        self.devices = self._flat.reshape(*shape)
        return self

    @property
    def size(self) -> int:
        return int(self._flat.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def shape_tuple(self) -> tuple:
        return tuple(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> list:
        """The devices in shard order."""
        return list(self._flat)

    @property
    def process_count(self) -> int:
        return int(self.process_index.max()) + 1 if self.size else 1

    def local_shards(self) -> list:
        """This process's shard positions, in order."""
        return [s for s in range(self.size) if int(self.process_index[s]) == self.process]

    def local_devices(self) -> list:
        """This process's devices, each once, in shard order."""
        out = []
        for s in self.local_shards():
            if self._flat[s] not in out:
                out.append(self._flat[s])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self._flat]})"


def make_mesh(num_devices: int = 0, devices=None, *, tenant_devices: int = 0) -> Mesh:
    """Device mesh over the partition axis — 2-D over ``(tenants,
    partitions)`` when ``tenant_devices > 1`` (JAX ``make_mesh``).

    ``devices`` is a sequence of devices (``"cpu"``, ``"cuda:0"`` or
    ``torch.device``, repeats allowed) or one device name; ``None`` is every
    visible card (``device.resolve_devices("cuda")``). ``num_devices > 0``
    takes the first that many."""
    from ..device import resolve_devices

    devices = resolve_devices("cuda" if devices is None else devices)
    if num_devices:
        devices = devices[:num_devices]
    if tenant_devices and tenant_devices > 1:
        if len(devices) % tenant_devices:
            raise ValueError(
                f"{len(devices)} device(s) do not split into a "
                f"{tenant_devices}-row tenant axis"
            )
        return Mesh(devices, (TENANT_AXIS, PARTITION_AXIS)).reshape(tenant_devices, -1)
    return Mesh(devices, (PARTITION_AXIS,))


def resolve_mesh(devices, partitions: int, *, mesh_devices: int = 0,
                 tenant_devices: int = 0, tenants: "int | None" = 1,
                 model=None) -> "Mesh | None":
    """The mesh a plane of ``partitions`` rows (a stacked plane's tenant ·
    partition rows) runs on over ``devices``, by the JAX package's
    ``_build_runner`` rule — the one rule every entry point that is given
    devices rather than a mesh follows: ``mesh_devices`` (0: every device)
    clamped to the devices there are; one for a host-callback ``model`` (an
    explicit ``mesh_devices > 1`` is refused); stepped down while it does
    not divide ``partitions``; a ``tenant_devices > 1`` tenant axis must
    divide ``tenants`` (None: the caller checks, as ``ChunkedDetector``
    does) and that width. None (unsharded) at width 1."""
    from ..device import resolve_devices

    devices = resolve_devices(devices)
    n_dev = min(int(mesh_devices) or len(devices), len(devices))
    if model is not None and model.host_callback:
        if mesh_devices > 1:
            raise ValueError(
                f"model {model.name!r} uses a host callback and cannot run on "
                f"a {mesh_devices}-device mesh; set mesh_devices=0"
            )
        n_dev = 1
    while n_dev > 1 and partitions % n_dev:
        n_dev -= 1
    tenant_devices = int(tenant_devices or 0)
    if tenant_devices > 1:
        if tenants is not None and max(int(tenants), 1) % tenant_devices:
            raise ValueError(
                f"{max(int(tenants), 1)} tenant(s) do not split over the requested "
                f"{tenant_devices}-row tenant mesh axis "
                "(mesh_tenant_devices must divide tenants)"
            )
        if n_dev % tenant_devices:
            raise ValueError(
                f"{n_dev} usable device(s) do not split over the "
                f"requested {tenant_devices}-row tenant mesh axis"
            )
    if n_dev <= 1:
        return None
    return make_mesh(n_dev, devices, tenant_devices=tenant_devices if tenant_devices > 1 else 0)


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: ``P()`` replicates a leaf, ``P(axes)``
    splits its leading axis over the named mesh axes."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A placement on a mesh (JAX's ``NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def splits(self) -> bool:
        """Whether the leaf's leading axis is split over the shards (else
        every shard holds all of it)."""
        return len(self.spec) > 0 and self.spec[0] is not None


def plane_axes(mesh: Mesh):
    """The mesh axis name(s) the flattened ``(tenant·partition)`` leading
    axis splits over: both on a 2-D tenant mesh, tenant-major; plain
    ``PARTITION_AXIS`` on a 1-D mesh."""
    if TENANT_AXIS in mesh.axis_names:
        return (TENANT_AXIS, PARTITION_AXIS)
    return PARTITION_AXIS


def plane_sharding(mesh: Mesh, rows: "int | None" = None) -> NamedSharding:
    """The sharding of a plane-major array; with ``rows`` (the leading
    axis's width) it checks that the mesh divides it."""
    if rows is not None and rows % mesh.size:
        raise ValueError(
            f"leading axis of {rows} row(s) not divisible by the "
            f"{mesh.size}-device mesh (shape {mesh.shape})"
        )
    return NamedSharding(mesh, P(plane_axes(mesh)))


def partition_sharding(mesh: Mesh, partitions: "int | None" = None) -> NamedSharding:
    """:func:`plane_sharding` under its historical name."""
    return plane_sharding(mesh, partitions)


# -- trees -------------------------------------------------------------------


class _Shape(NamedTuple):
    """A leaf's shape alone (a template leaf for the rules)."""

    shape: tuple


def _is_leaf(x) -> bool:
    return isinstance(x, (PartitionSpec, NamedSharding, _Shape))


def _map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, NamedTuples,
    tuples and lists (``None`` is an empty node), rebuilt."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest), path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not _is_leaf(tree):
        if hasattr(tree, "_fields"):
            return type(tree)(*(
                _map_with_path(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                               path=path + (f,))
                for f in tree._fields
            ))
        return type(tree)(
            _map_with_path(fn, v, *(r[i] for r in rest), path=path + (str(i),))
            for i, v in enumerate(tree)
        )
    return fn(path, tree, *rest)


def match_partition_rules(rules, tree, *, mesh: "Mesh | None" = None):
    """Per-leaf ``regex → PartitionSpec`` over a tree (JAX
    ``match_partition_rules``): a leaf is named by its ``/``-joined path
    (``params/centroids``, ``ddm/p_min``, ``a_X``) and takes the first
    matching rule's spec (``re.search``). A scalar leaf (no dimension, or
    one element) replicates (``P()``), as does a leaf no rule matches (pass
    a catch-all ``(".*", spec)`` tail to rule that out). Returns the tree of
    specs, or of :class:`NamedSharding` when ``mesh`` is given."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()
        name = "/".join(path)
        for pat, spec in compiled:
            if pat.search(name) is not None:
                return spec
        return P()

    specs = _map_with_path(spec_for, tree)
    if mesh is None:
        return specs
    return _map_with_path(lambda _, s: NamedSharding(mesh, s), specs)


def plane_rules(mesh: Mesh):
    """The rule list of a plane-major state tree (the engines'
    ``LoopCarry``): every named family splits its leading axis over the
    mesh's plane axes, with a catch-all tail; scalars still replicate. All
    map to one spec today, as in the JAX package: the named rules are the
    place where a family's placement would diverge."""
    spec = P(plane_axes(mesh))
    return (
        (r"params/|^params$", spec),
        (r"ddm|^state", spec),
        (r"^a_[Xyw]$", spec),
        (r"^retrain$", spec),
        (r"^key$", spec),
        (r".*", spec),
    )


def plane_shardings(mesh: Mesh, tree):
    """The :class:`NamedSharding` tree of a plane-major state tree
    (:func:`match_partition_rules` over :func:`plane_rules`)."""
    return match_partition_rules(plane_rules(mesh), tree, mesh=mesh)


def shard_bounds(mesh: Mesh, rows: int) -> list:
    """``(position, lo, hi, device)`` of each of this process's shards of a
    ``rows``-wide plane (contiguous, equal, in device order)."""
    plane_sharding(mesh, rows)  # the mesh must divide the rows
    per = rows // mesh.size
    return [(s, s * per, (s + 1) * per, mesh.flat[s]) for s in mesh.local_shards()]


def _to(x, dev: torch.device):
    """A leaf on ``dev``: a tensor moved, a numpy array kept on the host."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return x


def split_tree(tree, mesh: Mesh, shardings=None) -> list:
    """This process's shards of a plane-major tree, in order: a split leaf
    is cut to the shard's rows, a replicated one copied once per distinct
    device. Tensor leaves go to the shard's device; numpy leaves (the
    carry's host keys) stay on the host."""
    if shardings is None:
        shardings = plane_shardings(mesh, tree)
    rows = None
    for path_leaf in _leaves(tree, shardings):
        leaf, sh = path_leaf
        if sh.splits:
            rows = int(leaf.shape[0])
            break
    bounds = shard_bounds(mesh, rows) if rows is not None else [
        (s, 0, 0, mesh.flat[s]) for s in mesh.local_shards()]
    copies: dict = {}

    def replica(leaf, dev):
        key = (id(leaf), dev)
        if key not in copies:
            copies[key] = _to(leaf, dev)
        return copies[key]

    out = []
    for _, lo, hi, dev in bounds:
        out.append(_map_with_path(
            lambda _p, leaf, sh, lo=lo, hi=hi, dev=dev: (
                _to(leaf[lo:hi], dev) if sh.splits else replica(leaf, dev)
            ),
            tree, shardings,
        ))
    return out


def _leaves(tree, shardings) -> list:
    acc = []
    _map_with_path(lambda _p, leaf, sh: acc.append((leaf, sh)), tree, shardings)
    return acc


def _whole_shardings(shards: list, mesh: Mesh):
    """:func:`plane_shardings` of the whole tree that :func:`split_tree`
    cut into ``shards``, read off the shards' shapes."""
    template = _map_with_path(
        lambda _p, *xs: _Shape(
            (sum(int(x.shape[0]) for x in xs), *tuple(xs[0].shape)[1:])
            if len(getattr(xs[0], "shape", ())) else ()
        ),
        shards[0], *shards[1:],
    )
    return plane_shardings(mesh, template)


def gather_tree(shards: list, mesh: Mesh, device: "torch.device | None" = None,
                shardings=None):
    """The whole tree of :func:`split_tree`'s shards: split leaves joined
    along the leading axis (tensors on ``device``, the first shard's by
    default; numpy leaves on the host), replicated ones taken from the
    first shard. Which leaves were split is read off the whole tree's
    shapes (:func:`_whole_shardings`) unless ``shardings`` says."""
    if shardings is None:
        shardings = _whole_shardings(shards, mesh)

    def join(_p, sh, *xs):
        if not sh.splits:
            return xs[0]
        if isinstance(xs[0], torch.Tensor):
            dev = device if device is not None else xs[0].device
            return torch.cat([x.to(dev) for x in xs], 0) if len(xs) > 1 else xs[0].to(dev)
        return np.concatenate([np.asarray(x) for x in xs], 0)

    return _map_with_path(join, shardings, *shards)


def tree_rows(shards: list, spans, mesh: Mesh, lo: int, hi: int,
              device: "torch.device | None" = None):
    """Rows ``[lo, hi)`` of the whole tree that :func:`split_tree` cut into
    ``shards`` (shard ``i`` holding its rows ``spans[i] = (a, b)``): the
    part of the range each shard holds, joined by :func:`gather_tree`. Only
    those rows are copied; replicated leaves come from the first shard."""
    shardings = _whole_shardings(shards, mesh)
    parts = []
    for (a, b), tree in zip(spans, shards):
        s, e = max(lo, a) - a, min(hi, b) - a
        if s < e:
            parts.append(_map_with_path(
                lambda _p, leaf, sh, s=s, e=e: leaf[s:e] if sh.splits else leaf,
                tree, shardings,
            ))
    return gather_tree(parts, mesh, device, shardings)


def set_tree_rows(shards: list, spans, mesh: Mesh, lo: int, sub) -> list:
    """The shards with rows ``[lo, lo + n)`` of the whole tree set to those
    of ``sub`` (a tree of ``n`` rows, :func:`tree_rows`'s shape): a leaf
    that changes is copied, never written in place; replicated leaves and
    shards outside the range are kept."""
    shardings = _whole_shardings(shards, mesh)
    n = next(int(leaf.shape[0]) for leaf, sh in _leaves(sub, shardings) if sh.splits)
    out = []
    for (a, b), tree in zip(spans, shards):
        s, e = max(lo, a), min(lo + n, b)
        if s >= e:
            out.append(tree)
            continue

        def put(_p, leaf, sh, new, a=a, s=s, e=e):
            if not sh.splits:
                return leaf
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.clone()
                leaf[s - a:e - a] = torch.as_tensor(new[s - lo:e - lo]).to(leaf.device)
            else:
                leaf = np.array(leaf)
                leaf[s - a:e - a] = np.asarray(new)[s - lo:e - lo]
            return leaf

        out.append(_map_with_path(put, tree, shardings, sub))
    return out


def run_shards(devices, fn, *args) -> list:
    """``fn(*shard_args)`` for each shard, in shard order, with its device
    (``devices[i]``) the current card: ``args`` are per-shard sequences,
    zipped. The one loop every meshed engine runs its shards through; the
    shards run one after another on this thread."""
    out = []
    for dev, *a in zip(devices, *args):
        with on_device(dev):
            out.append(fn(*a))
    return out


def join_flags(parts: list, device: torch.device) -> FlagRows:
    """The shards' flag tables joined along the partition axis on
    ``device``."""
    if len(parts) == 1:
        return parts[0]
    return FlagRows(*(
        torch.cat([leaf.to(device) for leaf in leaves], 0) for leaves in zip(*parts)
    ))


@contextlib.contextmanager
def on_device(dev: torch.device):
    """Make ``dev`` the current card while launching a shard's work."""
    if dev.type == "cuda" and dev.index is not None:
        with torch.cuda.device(dev):
            yield
    else:
        yield


# -- the run's result and the collect epilogue -------------------------------


class MeshRunResult(NamedTuple):
    flags: FlagRows  # leaves [P, NB-1] (this process's rows of the plane)
    drift_vote: torch.Tensor  # [NB-1] f32: fraction of partitions flagging change
    packed: torch.Tensor  # [5, P, NB-1] i32: the five flag leaves stacked
    # [capacity + 1, 7] i32 compacted table (None when compaction is off):
    # columns (partition, batch, warning_local, warning_global,
    # change_local, change_global, forced_retrain), −1 fill, and the TOTAL
    # flagged-slot count in the last row's first column.
    compact: "torch.Tensor | None" = None
    # The whole plane's rows, where ``packed`` holds only this process's
    # (a mesh across processes); 0: ``packed``'s own.
    partitions: int = 0


def auto_compact_capacity(partitions: int, flag_rows: int) -> int:
    """Default compacted-table capacity for a ``[P, NBF]`` flag plane:
    ~P·NBF/8 entries (floor 64), clamped to the slot count."""
    slots = max(int(partitions) * int(flag_rows), 1)
    return min(max(64, slots // 8), slots)


def pack_flags(flags: FlagRows) -> torch.Tensor:
    """The five flag leaves stacked into one ``[5, P, NBF]`` int32 plane."""
    return torch.stack([leaf.int() for leaf in flags])


def compact_flag_table_reference(
    packed: torch.Tensor, capacity: int, partition_offset: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`compact_flag_table` on the packed
    plane, on its device: a slot's rank is the running count of flagged
    slots, and flagged slots of rank below capacity are scattered to their
    rank (the rest to a dropped overflow slot)."""
    k = int(capacity)
    _, p, nbf = packed.shape
    dev = packed.device
    planes = packed.reshape(5, -1)
    flat = (planes[0] >= 0) | (planes[2] >= 0) | (planes[4] != 0)
    n = flat.sum(dtype=torch.int32)  # true count — may exceed capacity
    rank = torch.cumsum(flat, 0) - 1
    slot = torch.where(flat & (rank < k), rank, k)
    pos = torch.full((k + 1,), -1, dtype=torch.long, device=dev)
    pos.scatter_(0, slot, torch.arange(p * nbf, device=dev))
    pos = pos[:k]
    ok = pos >= 0
    safe = pos.clamp_min(0)
    fill = torch.full_like(pos, -1)
    if p * nbf == 0:  # no slot: nothing to gather
        entries = torch.full((k, 7), -1, dtype=torch.int32, device=dev)
    else:
        entries = torch.stack(
            [torch.where(ok, pos // nbf + int(partition_offset), fill),
             torch.where(ok, pos % nbf, fill)]
            + [torch.where(ok, planes[i][safe].long(), fill) for i in range(5)],
            dim=1,
        ).int()  # [K, 7]
    counter = torch.zeros((1, 7), dtype=torch.int32, device=dev)
    counter[0, 0] = n
    return torch.cat([entries, counter], 0)


def k4_words(p: int, nbf: int, k: int) -> int:
    """The int32 words of K4's launch buffer (``csrc/flag_compact.cu``
    ``flag_compact_words``): the ``[k + 1, 7]`` table padded to 8 bytes,
    a 64-bit status word a tile of 2,048 slots, and the tile counter."""
    table = (int(k) + 1) * 7
    tiles = max(1, -(-int(p) * int(nbf) // K4_TILE))
    return ((table + 1) & ~1) + 2 * tiles + 1


K4_TILE = 2048  # csrc/flag_compact.cu kThreads · kItems


def compact_flag_table(flags, capacity: int, partition_offset: int = 0) -> torch.Tensor:
    """``FlagRows [P, NBF]`` (or their packed ``[5, P, NBF]`` int32 plane)
    → ``[capacity + 1, 7]`` int32 table of the first ``min(n, capacity)``
    flagged slots in row-major order, −1 fill, with the true count ``n`` in
    the last row. A slot is flagged when it holds a warning, a change or a
    forced retrain; its partition column is ``partition_offset`` plus its
    row (a mesh shard's first partition).

    CUDA tensors launch kernel K4 (``csrc/flag_compact.cu``: one pass, a
    slot's rank from warp ballots, a CTA scan and a decoupled look-back
    across tiles; the count written on the device) and add one to
    ``compact_flag_table.launches``; CPU tensors run
    :func:`compact_flag_table_reference`. Neither synchronizes with the
    host."""
    packed = flags if isinstance(flags, torch.Tensor) else pack_flags(flags)
    if packed.device.type == "cpu":
        return compact_flag_table_reference(packed, capacity, partition_offset)
    if packed.device.type != "cuda":
        raise ValueError(f"compact_flag_table: unsupported device {packed.device}")
    from .. import kernels

    k = int(capacity)
    if packed.dim() != 3 or packed.shape[0] != 5:
        raise ValueError(f"compact_flag_table: packed must be [5, P, NBF], got "
                         f"{tuple(packed.shape)}")
    _, p, nbf = packed.shape
    if p * nbf > 2**31 - 1 - K4_TILE or (k + 1) * 7 > 2**31 - 1:
        raise ValueError(f"compact_flag_table: {p * nbf} slots or capacity {k} "
                         "beyond int32 indexing")
    packed = packed.to(torch.int32).contiguous()
    buf = torch.empty(k4_words(p, nbf, k), dtype=torch.int32, device=packed.device)
    with on_device(packed.device):
        code = kernels.launcher("flag_compact")(
            packed.data_ptr(), p, nbf, k, int(partition_offset), buf.data_ptr(),
            kernels.stream_handle(packed.device),
        )
    kernels.check("flag_compact", code)
    compact_flag_table.launches += 1
    return buf[: (k + 1) * 7].view(k + 1, 7)


compact_flag_table.launches = 0


def merge_compact_tables(tables, capacity: int) -> torch.Tensor:
    """One ``[capacity + 1, 7]`` table from the shards' tables (each of the
    same capacity, in shard order): the shards' entries in order, the first
    ``capacity`` kept, −1 beyond, and the count the sum of theirs — the
    whole plane's table, since a shard's first ``capacity`` flagged slots
    hold every one of its slots the whole plane's first ``capacity`` can
    take. On the first table's device, with no host synchronization."""
    if len(tables) == 1:
        return tables[0]
    k = int(capacity)
    dev = tables[0].device
    t = torch.stack([x.to(dev) for x in tables])  # [S, K+1, 7]
    counts = t[:, k, 0].long()
    kept = counts.clamp(max=k)
    start = torch.cumsum(kept, 0) - kept
    j = torch.arange(k, device=dev)
    rank = start[:, None] + j[None, :]
    slot = torch.where((j[None, :] < kept[:, None]) & (rank < k), rank, k)
    out = torch.full((k + 1, 7), -1, dtype=torch.int32, device=dev)
    out.index_copy_(0, slot.reshape(-1), t[:, :k].reshape(-1, 7))
    out[k] = 0
    out[k, 0] = counts.sum().int()
    return out


def expand_flag_table(
    table: np.ndarray, partitions: int, flag_rows: int
) -> FlagRows | None:
    """Host-side inverse of :func:`compact_flag_table`: scatter the entries
    into a sentinel-initialised ``[P, NBF]`` flag plane; ``None`` when the
    embedded count exceeds the capacity (the table is partial)."""
    table = np.asarray(table)
    capacity = table.shape[0] - 1
    n_events = int(table[-1, 0])
    if n_events > capacity:
        return None
    entries = table[:capacity]
    entries = entries[entries[:, 0] >= 0]
    shape = (int(partitions), int(flag_rows))
    leaves = [np.full(shape, -1, np.int32) for _ in range(4)]
    forced = np.zeros(shape, bool)
    pq, bq = entries[:, 0], entries[:, 1]
    for col, leaf in enumerate(leaves, start=2):
        leaf[pq, bq] = entries[:, col]
    forced[pq, bq] = entries[:, 6] != 0
    return FlagRows(*leaves, forced)


def unpack_flags(packed: np.ndarray) -> FlagRows:
    """Host :class:`FlagRows` from ``MeshRunResult.packed``."""
    return FlagRows(
        *(packed[i] for i in range(4)), packed[4].astype(bool)
    )


def host_flags(result: MeshRunResult) -> tuple[FlagRows, dict]:
    """The collect phase's device→host step: host ``FlagRows`` plus a
    provenance dict (``mode``, ``events``, ``overflow``). A compacted
    table that overflowed falls back to the full plane with a
    ``RuntimeWarning`` — never a silent truncation."""
    if result.compact is not None:
        _, p, nbf = result.packed.shape
        p = result.partitions or p
        table = result.compact.cpu().numpy()  # ONE small device→host copy
        n_events = int(table[-1, 0])
        flags = expand_flag_table(table, p, nbf)
        if flags is not None:
            return flags, {"mode": "compact", "events": n_events, "overflow": False}
        if result.partitions and result.partitions != result.packed.shape[1]:
            raise RuntimeError(
                f"compacted flag table overflowed ({n_events} flagged slots > "
                f"capacity {table.shape[0] - 1}) on a mesh across processes, "
                "where each process holds only its own rows of the plane; raise "
                "RunConfig.collect_capacity or use collect='full'"
            )
        warnings.warn(
            f"compacted flag table overflowed ({n_events} flagged slots > "
            f"capacity {table.shape[0] - 1}); falling back to the full "
            "flag plane — raise RunConfig.collect_capacity or use "
            "collect='full' for this stream",
            RuntimeWarning,
            stacklevel=2,
        )
        return unpack_flags(result.packed.cpu().numpy()), {
            "mode": "full", "events": n_events, "overflow": True,
        }
    if result.partitions and result.partitions != result.packed.shape[1]:
        raise RuntimeError(
            f"no compacted flag table on a mesh across processes: this process "
            f"holds {result.packed.shape[1]} of the plane's {result.partitions} "
            "rows; collect with collect='compact' (and validate=False), or "
            "read each process's own rows from MeshRunResult.packed"
        )
    return unpack_flags(result.packed.cpu().numpy()), {
        "mode": "full", "events": None, "overflow": False,
    }


def split_tenant_flags(flags: FlagRows, tenants: int, flag_cols=None) -> "list[FlagRows]":
    """Per-tenant views ``[P, NBF]`` of a stacked ``[T·P, NBF]`` flag plane
    (``[P, flag_cols[t]]`` when the tenants' flag widths are given: a
    ragged tenant's padded trailing columns are sentinel and dropped), as
    the JAX package's ``split_tenant_flags``. Host numpy or tensors."""
    tp = flags.change_global.shape[0]
    if tenants < 1 or tp % tenants:
        raise ValueError(
            f"stacked flag plane of {tp} rows does not split into {tenants} tenants"
        )
    p = tp // tenants
    out = []
    for t in range(tenants):
        sl = FlagRows(*(leaf[t * p:(t + 1) * p] for leaf in flags))
        if flag_cols is not None:
            w = int(flag_cols[t])
            sl = FlagRows(*(leaf[:, :w] for leaf in sl))
        out.append(sl)
    return out


def tenant_drift_vote(flags: FlagRows) -> np.ndarray:
    """One tenant's drift vote: the float32 fraction of its partitions
    flagging a change at each step (:func:`merge_shards`' arithmetic)."""
    changed = (np.asarray(flags.change_global) >= 0).astype(np.float32)
    return changed.sum(axis=0, dtype=np.float32) / np.float32(changed.shape[0])


def merge_shards(outs, mesh: "Mesh | None" = None, rows: "int | None" = None,
                 compact_capacity: int = 0) -> MeshRunResult:
    """The end-of-run epilogue (JAX ``finish_mesh_run``) of a one-device
    run (``mesh`` None, one shard) or of this process's shards of a mesh.
    ``outs`` is ``[(lo, FlagRows)]`` in shard order, ``rows`` the whole
    plane's (default: the shards' rows). Each shard packs its flags,
    counts its changed partitions a step and, with ``compact_capacity``,
    compacts its plane with K4 at that global capacity and its offset; the
    counts are summed and divided once by ``rows``, the planes joined and
    the tables merged (:func:`merge_compact_tables`) on the first shard's
    device. A mesh across processes sums the counts and gathers the tables
    over ``torch.distributed`` (``parallel/multihost.py``); ``flags`` and
    ``packed`` keep this process's rows."""
    if not outs:
        raise ValueError("this process holds no shard of the mesh")
    dev0 = outs[0][1].change_global.device
    devices = [fl.change_global.device for _, fl in outs]

    def epilogue(lo, fl):
        pk = pack_flags(fl)
        count = (fl.change_global >= 0).sum(0, dtype=torch.int32)
        table = compact_flag_table(pk, compact_capacity, lo) if compact_capacity else None
        return pk, count, table

    planes, counts, tables = zip(*run_shards(devices, epilogue, *zip(*outs)))
    packed = planes[0] if len(planes) == 1 else torch.cat([pk.to(dev0) for pk in planes], 1)
    if rows is None:
        rows = int(packed.shape[1])
    count = counts[0]
    for c in counts[1:]:
        count = count + c.to(dev0)
    compact = merge_compact_tables(tables, compact_capacity) if compact_capacity else None
    processes = mesh.process_count if mesh is not None else 1
    if processes > 1:
        from .multihost import all_reduce_counts, all_gather_tables

        count = all_reduce_counts(count)
        if compact is not None:
            compact = merge_compact_tables(all_gather_tables(compact), compact_capacity)
    vote = count.float() / rows
    flags = FlagRows(packed[0], packed[1], packed[2], packed[3], packed[4].bool())
    return MeshRunResult(flags=flags, drift_vote=vote, packed=packed, compact=compact,
                         partitions=int(rows) if processes > 1 else 0)


# -- the runner and the placement of its stream -----------------------------


class Shard(NamedTuple):
    """One shard of a placed plane: its mesh position, its rows ``[lo,
    hi)`` of the whole plane, its device, its batches there and (a keyed
    model) its partitions' keys ``[hi − lo, 2]`` uint32."""

    index: int
    lo: int
    hi: int
    device: torch.device
    batches: object
    key: object = None


class ShardedBatches(NamedTuple):
    """A striped stream placed on a mesh: this process's shards and the
    whole plane's rows."""

    shards: tuple
    rows: int
    mesh: Mesh


def _put(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def shard_batches(batches, keys, mesh: "Mesh | None", device="cuda", partitions=None):
    """Host→device placement of the striped stream (JAX ``shard_batches``):
    ``(placed, keys)``. Without a mesh the batches go to ``device`` whole.
    On a mesh the plane-major leaves are cut to each of this process's
    shards and a shared leaf (the packed stream's row table) is copied once
    per distinct device; ``keys`` (``[P, 2]`` uint32, or None) are cut the
    same way and ride in the shards. ``partitions`` is the whole plane's
    rows when ``batches`` hold only this process's stripe
    (``multihost.shard_batches_global``); the stripe then starts at this
    process's first shard."""
    if mesh is None:
        from ..device import resolve_device

        dev = resolve_device(device) if not isinstance(device, torch.device) else device
        return _place_whole(batches, dev), keys
    packed = isinstance(batches, PackedIndexedBatches)
    plane = batches.idx if packed else batches.y
    local_rows = int(plane.shape[0])
    rows = int(partitions) if partitions is not None else local_rows
    bounds = shard_bounds(mesh, rows)
    base = bounds[0][1] if partitions is not None and bounds else 0
    replicas: dict = {}

    def replica(name, a, dev):
        if (name, dev) not in replicas:
            replicas[(name, dev)] = _put(a, dev)
        return replicas[(name, dev)]

    shards = []
    for s, lo, hi, dev in bounds:
        a, b = lo - base, hi - base
        if packed:
            placed = PackedIndexedBatches(
                base_X=replica("X", batches.base_X, dev),
                base_y=replica("y", batches.base_y, dev),
                idx=_put(batches.idx[a:b], dev),
                perm=_put(batches.perm[a:b], dev),
                n_rows=int(batches.n_rows),
            )
        else:
            placed = Batches(*(_put(leaf[a:b], dev) for leaf in batches))
        k = None if keys is None else np.asarray(keys)[a:b]
        shards.append(Shard(s, lo, hi, dev, placed, k))
    return ShardedBatches(tuple(shards), rows, mesh), keys


def _place_whole(batches, dev: torch.device):
    if isinstance(batches, PackedIndexedBatches):
        return PackedIndexedBatches(
            base_X=_put(batches.base_X, dev),
            base_y=_put(batches.base_y, dev),
            idx=_put(batches.idx, dev),
            perm=_put(batches.perm, dev),
            n_rows=int(batches.n_rows),
        )
    return Batches(*(_put(leaf, dev) for leaf in batches))


def make_mesh_runner(
    model: Model,
    ddm_params: DDMParams,
    mesh: "Mesh | None" = None,
    *,
    retrain_error_threshold: float | None = None,
    window: int = 16,
    packed: bool = False,
    detector=None,
    rotations: int = 1,
    compact_capacity: int = 0,
):
    """Build ``run(batches, key=None) -> MeshRunResult``; ``key`` is the
    whole plane's keys ``[P, 2]`` uint32 of a keyed model.

    Without a mesh, ``batches`` are on one device. On a mesh they are
    :class:`ShardedBatches` (:func:`shard_batches`): each shard runs the
    one-device runner over its rows on its device (with ``key[lo:hi]``, or
    the shard's own keys when ``key`` is None), and :func:`merge_shards`
    joins them — K4 once a shard. ``packed=True`` takes
    :class:`PackedIndexedBatches` and expands their geometry planes on the
    device first; otherwise ``batches`` are dense :class:`Batches`.
    ``window > 1`` is the speculative window engine, ``window = 1`` the
    sequential batch-per-step engine (dense batches only, ``rotations``
    1)."""
    from ..models.base import require_shardable

    require_shardable(model, mesh)
    if window == 0:
        raise ValueError(
            "window=0 (auto) needs stream geometry and is resolved by "
            "api.prepare (config.auto_window); pass an explicit width here"
        )
    if packed and window <= 1:
        raise ValueError("indexed batches require the window engine (window > 1)")
    if window <= 1 and rotations != 1:
        raise ValueError("rotations only applies to the window engine (window > 1)")
    if window > 1:
        from ..engine.window import make_window_runner

        run_one = make_window_runner(
            model,
            ddm_params,
            window=window,
            retrain_error_threshold=retrain_error_threshold,
            detector=detector,
            rotations=rotations,
        )
    else:
        from ..engine.loop import make_partition_runner

        run_one = make_partition_runner(
            model,
            ddm_params,
            shuffle=False,  # the stream is shuffled on the host at stripe time
            retrain_error_threshold=retrain_error_threshold,
            detector=detector,
        )

    def flags_of(batches, key, lo=0, rows=None):
        if packed:
            if not isinstance(batches, PackedIndexedBatches):
                raise TypeError("packed runner expects PackedIndexedBatches")
            batches = expand_packed(batches, lo, rows)
        return run_one(batches, key) if model.keyed else run_one(batches)

    def run(batches, key=None) -> MeshRunResult:
        if mesh is None:
            return merge_shards([(0, flags_of(batches, key))],
                                compact_capacity=compact_capacity)
        if not isinstance(batches, ShardedBatches):
            raise TypeError("a mesh runner expects ShardedBatches (parallel.mesh.shard_batches)")

        def shard_flags(sh):
            k = sh.key if key is None else np.asarray(key)[sh.lo:sh.hi]
            return sh.lo, flags_of(sh.batches, k, sh.lo, batches.rows)

        shards = batches.shards
        outs = run_shards([sh.device for sh in shards], shard_flags, shards)
        return merge_shards(outs, mesh, batches.rows, compact_capacity)

    return run
