"""The in-loop shuffle of the engines' ``shuffle=True`` (kernel K13).

The JAX package has no module for it: its loop engine permutes each batch
with ``jax.random.permutation(k_shuf, B)`` (``engine/loop.py:289-297``) and
its window engine each window row ``i`` with ``permutation(split(k_shuf,
W)[i], B)`` (``engine/window.py:211-223``), then gathers the batch's planes
through the permutation — operations XLA lowers. Here both are one
function of a span of batches, :func:`shuffle_planes`: for every
(partition, batch) the permutation of the batch's ``B`` places from the
batch's key, applied to its index plane, ``rows`` and ``valid``. A dense
stream is addressed through its flat row index (``engine/window.py``), so
the three planes are all there is to move.

On CUDA tensors it launches kernel K13 (``csrc/shuffle_perm.cu``), on CPU
tensors it runs :func:`shuffle_planes_reference`, which is
``utils/threefry.py`` ``permutation`` (``torch.sort(stable=True)``) and a
gather.
"""

from __future__ import annotations

import torch

from ..utils import threefry

# csrc/shuffle_perm.cu's constants: B up to K13_WARP_ITEMS sorts a batch a
# warp (K13_WARPS batches a CTA), up to K13_SHARED_ITEMS a batch a CTA of
# 16 composites a thread to a network width of K13_CTA_WIDE and 32 beyond,
# a larger B in global scratch.
K13_WARP_ITEMS = 1024
K13_WARPS = 4
K13_SHARED_ITEMS = 16384
K13_CTA_WIDE = 4096
K13_MAX_THREADS = 1024


def k13_layout(b: int, force: int = 0) -> dict:
    """Kernel K13's layout for batches of ``b`` places, the mirror of the
    kernel's own choice (``shuffle_perm_path``): the path (``warp``,
    ``cta`` or ``global``; ``force`` 1 takes the global one), the network's
    width (``b`` rounded up to a power of two, at least 32 on the warp
    path), composites a thread, threads a CTA, batches a CTA and its
    dynamic shared bytes."""
    b = int(b)
    n2 = 1 << max(0, (b - 1).bit_length())
    if not force and n2 <= K13_WARP_ITEMS:
        n2 = max(32, n2)
        k = n2 // 32
        return {"path": "warp", "npow2": n2, "per_thread": k, "threads": 32 * K13_WARPS,
                "warps": K13_WARPS, "shared_bytes": K13_WARPS * 105 * k * 4}
    if not force and n2 <= K13_SHARED_ITEMS:
        k = 16 if n2 <= K13_CTA_WIDE else 32
        return {"path": "cta", "npow2": n2, "per_thread": k, "threads": n2 // k, "warps": 1,
                "shared_bytes": 8 * (n2 + n2 // 32) + 4 * (b + b // 32 + 1)}
    return {"path": "global", "npow2": n2, "per_thread": 0,
            "threads": min(K13_MAX_THREADS, max(32, n2 // 2)), "warps": 1, "shared_bytes": 0}


K13_PATHS = ("warp", "cta", "global")  # shuffle_perm_path's path codes 0, 1, 2


def _keys_of(keys: torch.Tensor, p: int, width: int, derive: bool) -> torch.Tensor:
    """Each batch's key ``[P, W, 2]`` (int64 words): ``split(keys[p], W)[i]``
    when ``derive``, else ``keys[p, i]``."""
    k = keys.long() & threefry.M32
    return threefry.split(k.reshape(p, 2), width) if derive else k.reshape(p, width, 2)


def shuffle_planes_reference(
    keys, idx, rows, valid, width: int, start=None, *, derive: bool = True,
    tie_mask: int = threefry.M32,
):
    """Plain PyTorch version of :func:`shuffle_planes`, on the planes'
    device."""
    p, _, b = idx.shape
    dev = idx.device
    perm = threefry.permutation(_keys_of(keys, p, int(width), derive), b, tie_mask)
    s0 = torch.zeros(p, dtype=torch.int64, device=dev) if start is None else start.long()
    cols = s0[:, None] + torch.arange(int(width), dtype=torch.int64, device=dev)
    parts = torch.arange(p, device=dev)[:, None]

    def take(x):
        return torch.gather(x[parts, cols], 2, perm)

    return take(idx).to(torch.int32), take(rows), take(valid)


def shuffle_planes(
    keys, idx, rows, valid, width: int, start=None, *, derive: bool = True,
    tie_mask: int = threefry.M32, force: int = 0,
):
    """``width`` batches of every partition, each permuted as JAX permutes
    a batch: ``(idx [P, W, B] int32, rows [P, W, B] int32, valid [P, W, B]
    bool)``.

    Batch ``i`` of partition ``p`` is source batch ``start[p] + i`` (``start
    [P]`` int64, None: 0) of the planes ``idx [P, NB, B]`` (int16 or int32),
    ``rows`` (int32) and ``valid`` (bool); its key is ``split(keys[p],
    W)[i]`` when ``derive`` (``keys [P, 2]``: the window engine's ``k_shuf``
    of each lane), else ``keys[p, i]`` (``keys [P, W, 2]``: the loop
    engine's ``k_shuf`` of each step); keys are uint32 words held in int32
    (or int64). Out: ``x[p, i, m] = source[p, start[p] + i,
    perm_{p,i}[m]]`` with ``perm = jax.random.permutation(key, B)``.
    ``tie_mask`` ANDs every 32-bit draw (all ones: JAX's), so a test can
    force ties.

    CUDA tensors launch kernel K13 (``csrc/shuffle_perm.cu``: a warp a
    batch up to ``K13_WARP_ITEMS`` places, a CTA a batch up to
    ``K13_SHARED_ITEMS``, global scratch above; ``force`` 1 takes the
    global path at any B, see :func:`k13_layout`) and add one to
    ``shuffle_planes.launches``; CPU tensors run
    :func:`shuffle_planes_reference`."""
    if idx.device.type == "cpu":
        return shuffle_planes_reference(
            keys, idx, rows, valid, width, start, derive=derive, tie_mask=tie_mask
        )
    if idx.device.type != "cuda":
        raise ValueError(f"shuffle_planes: unsupported device {idx.device}")
    from .. import kernels

    width = int(width)
    if idx.dim() != 3 or idx.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"shuffle_planes: idx must be int16/int32 [P, NB, B], got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    p, nb, b = idx.shape
    if rows.shape != idx.shape or valid.shape != idx.shape:
        raise ValueError("shuffle_planes: idx, rows and valid must share one shape")
    if rows.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError("shuffle_planes: rows must be int32 and valid bool")
    want = (p, 2) if derive else (p, width, 2)
    keys = keys.to(device=idx.device, dtype=torch.int32).contiguous()
    if tuple(keys.shape) != want:
        raise ValueError(f"shuffle_planes: keys must be {want}, got {tuple(keys.shape)}")
    if start is not None:
        start = start.to(device=idx.device, dtype=torch.int64).contiguous()
        if tuple(start.shape) != (p,):
            raise ValueError(f"shuffle_planes: start must be [{p}]")
    idx, rows, valid = idx.contiguous(), rows.contiguous(), valid.contiguous()
    out_idx = torch.empty((p, width, b), dtype=torch.int32, device=idx.device)
    out_rows = torch.empty((p, width, b), dtype=torch.int32, device=idx.device)
    out_valid = torch.empty((p, width, b), dtype=torch.bool, device=idx.device)
    lay = k13_layout(b, force)
    scratch = None
    if lay["path"] == "global" and width:
        nbytes = p * width * (8 * lay["npow2"] + 4 * b)  # composites, permutations
        scratch = torch.empty((nbytes + 7) // 8, dtype=torch.int64, device=idx.device)
    code = kernels.launcher("shuffle_perm")(
        keys.data_ptr(), int(derive), p, width, idx.data_ptr(), idx.element_size(),
        rows.data_ptr(), valid.data_ptr(), None if start is None else start.data_ptr(),
        nb, b, threefry.permutation_rounds(b), int(tie_mask) & threefry.M32, int(force),
        out_idx.data_ptr(), out_rows.data_ptr(), out_valid.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        kernels.stream_handle(idx.device),
    )
    kernels.check("shuffle_perm", code)
    shuffle_planes.launches += 1
    return out_idx, out_rows, out_valid


shuffle_planes.launches = 0
