"""The per-partition MLP, fitted on the card from a threefry key.

Twin of the JAX package's ``models/classifiers.py`` ``make_mlp``
(:249-305), batched over partitions: ``hidden`` ReLU layers and a linear
output layer, params a tuple of :class:`MLPLayer` ``(w [P, din, dout], b
[P, dout])``, a fresh fit per microbatch of ``fit_steps`` full-batch SGD
steps with momentum from ``init(key)``.

The init is JAX's bit for bit: ``split(key, layers)``, then per layer the
normals of ``utils/threefry.py`` times ``√(2 / din)`` with zero biases.
Under ``jit`` (where the JAX engines run it) XLA folds ``√(2/din) ·
normal`` into ``erf_inv(u) · f32(√2 · √(2/din))``; the port computes that
form (:func:`init_scales`). The fit's matrix products cannot follow XLA's
unknown summation order (ROADMAP Queue C, C2), so fitted parameters agree
with JAX to a tolerance, not to the bit.

Three hand-written kernels carry the family on the card, each beside its
plain version: K8 (``utils/threefry.py`` ``init_normals``,
``csrc/random_normal.cu``: every layer's weights and the zero biases in one
launch) for ``init``,
K9 ``mlp_fit`` (``csrc/mlp_fit.cu``: init from the key and every SGD step
in one launch, a thread-block cluster a partition, :func:`k9_launch_plan`) and
K10 ``mlp_predict_err`` (``csrc/mlp_predict_err.cu``: the forward pass
over rows gathered from the padded row table, argmax and the error
indicator).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..ops.prefix import f32
from ..utils import threefry
from .base import Model, ModelSpec, pad_row_table, row_stride
from .classifiers import MAX_SHARED_BYTES, _argmax_first

# Layers a launch passes in a struct among the kernel's parameters, which
# are limited to 4 KB (csrc/mlp_fit.cu, csrc/mlp_predict_err.cu
# kInlineLayers); a deeper net's widths and pointers go in a device array
# (:func:`net_desc`), so the kernels take any depth.
INLINE_LAYERS = 64


class MLPLayer(NamedTuple):
    w: torch.Tensor  # [P, din, dout]
    b: torch.Tensor  # [P, dout]


def init_scales(dims) -> list[float]:
    """Per layer, the float32 factor XLA's jitted init multiplies
    ``erf_inv(u)`` by: ``f32(f32(√2) · f32(√f32(2 / din)))``."""
    sqrt2 = np.float32(math.sqrt(2.0))
    return [float(sqrt2 * np.sqrt(np.float32(2.0 / d))) for d in dims[:-1]]


def _keys(key: torch.Tensor) -> torch.Tensor:
    """Per-partition keys ``[P, 2]`` as int32 bit patterns on their device."""
    if not isinstance(key, torch.Tensor):
        key = torch.from_numpy(np.array(key, np.uint32).view(np.int32))
    return key.int() if key.dtype == torch.int64 else key


def mlp_init(key, dims, device=None, normal=None) -> tuple:
    """``make_mlp.init`` for every partition: ``key [P, 2]`` (uint32
    words; numpy or an int tensor) → a tuple of :class:`MLPLayer`. By
    default the weights and the zero biases are views of one buffer that
    ``threefry.init_normals`` fills — kernel K8 on the card, every layer in
    one launch. ``normal(keys, n, factor)`` instead draws layer by layer
    from ``split(key, L)`` (the composition K8 replaces; the plain versions
    pass ``threefry.random_normal_reference``)."""
    key = _keys(key)
    if device is not None:
        key = key.to(device)
    p = key.shape[0]
    pairs = list(zip(dims[:-1], dims[1:]))
    factors = init_scales(dims)
    if normal is not None:
        layer_keys = threefry.split(key, len(pairs)).int()  # [P, L, 2]
        return tuple(
            MLPLayer(normal(layer_keys[:, l].contiguous(), din * dout, factors[l]).view(p, din, dout),
                     torch.zeros((p, dout), dtype=torch.float32, device=key.device))
            for l, (din, dout) in enumerate(pairs))
    buf = threefry.init_normals(key, [din * dout for din, dout in pairs], factors,
                                zeros=p * sum(dims[1:]))
    out, w_at, b_at = [], 0, p * sum(din * dout for din, dout in pairs)
    for din, dout in pairs:
        out.append(MLPLayer(buf[w_at:w_at + p * din * dout].view(p, din, dout),
                            buf[b_at:b_at + p * dout].view(p, dout)))
        w_at, b_at = w_at + p * din * dout, b_at + p * dout
    return tuple(out)


def mlp_forward(params, X: torch.Tensor) -> torch.Tensor:
    """Logits ``[P, N, C]`` of ``X [P, N, F]`` (plain)."""
    h = X
    for layer in params[:-1]:
        h = torch.relu(torch.bmm(h, layer.w) + layer.b[:, None])
    last = params[-1]
    return torch.bmm(h, last.w) + last.b[:, None]


def mlp_fit_reference(key, X, y, w, dims, fit_steps: int, learning_rate: float,
                      momentum: float) -> tuple:
    """Plain PyTorch version of :func:`mlp_fit`: the gradient of JAX's
    ``loss_fn`` written out as its VJP computes it — ``log_softmax`` with
    the max shift held constant, ``g + e·(−Σg / Σe)`` for its backward,
    ReLU's gradient where the activation is positive — with ``wn = w /
    max(Σw, 1)``, then ``vel = m·vel − lr·g``, ``p = p + vel``; every
    gradient from the old parameters."""
    params = [list(layer) for layer in
              mlp_init(key, dims, X.device, threefry.random_normal_reference)]
    X, w = X.float(), w.float()
    c = dims[-1]
    onehot = ((torch.arange(c, device=X.device) == y[..., None].long())).float()
    wn = w / w.sum(1, keepdim=True).clamp_min(1.0)
    g_logp = -(wn[..., None] * onehot)
    g_sum = g_logp.sum(-1, keepdim=True)
    vel = [[torch.zeros_like(t) for t in layer] for layer in params]
    lr, mom = f32(learning_rate), f32(momentum)
    for _ in range(int(fit_steps)):
        acts = [X]
        for l, (W, b) in enumerate(params):
            z = torch.bmm(acts[-1], W) + b[:, None]
            acts.append(torch.relu(z) if l < len(params) - 1 else z)
        logits = acts.pop()
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        d = g_logp + e * (-g_sum / e.sum(-1, keepdim=True))
        grads = []
        for l in reversed(range(len(params))):
            grads.append((torch.bmm(acts[l].transpose(1, 2), d), d.sum(1)))
            if l:
                d = torch.where(acts[l] > 0, torch.bmm(d, params[l][0].transpose(1, 2)), 0.0)
        for l, g in enumerate(reversed(grads)):
            for k in range(2):
                vel[l][k] = mom * vel[l][k] - lr * g[k]
                params[l][k] = params[l][k] + vel[l][k]
    return tuple(MLPLayer(*layer) for layer in params)


def _r4(n: int) -> int:
    return (n + 3) & ~3


def _k9_header(layers: int) -> int:
    """Words of K9's header at the head of its workspace: 9 ints a layer
    and 6, rounded up to 4 (csrc/mlp_fit.cu ``header_words``)."""
    return (9 * layers + 6 + 3) & ~3


def _pad4(n: int) -> int:
    """K9's row stride for n floats (csrc/mlp_fit.cu ``pad4``): at least n
    rounded up to 4, and 4 times an odd number."""
    return ((((n + 3) & ~3) // 4) | 1) * 4


def _k9_words(dims, b: int, cs: int = 1) -> int:
    """Floats of one CTA's workspace in K9 with ``cs`` CTAs a partition
    (csrc/mlp_fit.cu ``layout``): its header (:func:`_k9_header`
    words), the parameters with each weight row padded (``_pad4``), the
    velocities of the CTA's columns (the widest slice, whole groups of 4,
    of each layer), each layer's output with padded rows, with ``cs > 1`` a
    gradient buffer as wide for each hidden layer but the first, a float a
    row, the rows (padded), labels and weights — each region rounded up to
    4 floats. The kernel's own count, ``mlp_fit_words``, sizes a launch;
    this copy lets :func:`k9_plan` be worked out without a card."""
    r4 = _r4

    def widest(n):  # csrc/mlp_fit.cu `cut`: whole groups of 4 a CTA
        return 4 * -(-((n + 3) // 4) // cs)

    pairs = list(zip(dims[:-1], dims[1:]))
    params = sum(r4(din * _pad4(dout)) + r4(dout) for din, dout in pairs)
    vel = sum(r4(din * widest(dout)) + r4(widest(dout)) for din, dout in pairs)
    acts = sum(r4(b * _pad4(d)) for d in dims[1:])
    grads = sum(r4(b * _pad4(d)) for d in dims[2:-1]) if cs > 1 else 0
    return (_k9_header(len(pairs)) + params + vel + acts + grads + r4(b) + r4(b * _pad4(dims[0]))
            + 2 * r4(b))


# CTAs a partition K9 takes (csrc/mlp_fit.cu `valid_cs`), and the cluster
# sizes its plan tries, in this order: on an H100 at the main path's shapes
# 4 CTAs a partition ran fastest, 2 next; 8 ran slower than 4 (PERF.md §6).
K9_CTAS = (1, 2, 4, 8)
K9_CLUSTER_SIZES = (4, 2)


def k9_plan(p: int, words, max_clusters) -> tuple[int, bool]:
    """K9's launch at ``P = p`` partitions: ``(cs, shared)``, the CTAs a
    partition and whether the workspace sits in shared memory, from
    ``words(cs)`` (the floats of one CTA's workspace) and
    ``max_clusters(cs)`` (the clusters the card holds at once). The first
    ``cs`` of :data:`K9_CLUSTER_SIZES` whose workspace fits shared memory
    and whose ``p`` clusters are all resident; else one CTA a partition,
    its workspace in shared memory if it fits there, else in global
    memory. The card is asked only about sizes that fit."""
    for cs in K9_CLUSTER_SIZES:
        if 4 * words(cs) <= MAX_SHARED_BYTES and max_clusters(cs) >= p:
            return cs, True
    return 1, 4 * words(1) <= MAX_SHARED_BYTES


@functools.cache
def k9_launch_plan(device: torch.device, dims: tuple, b: int, p: int) -> tuple[int, int | None]:
    """:func:`k9_plan` on ``device`` from the kernel's own counts
    (``mlp_fit_words``, ``mlp_fit_max_clusters``), worked out once per
    (device, shape): ``(cs, scratch_words)``, ``scratch_words`` the floats
    of a partition's global workspace, or ``None`` when the workspace sits
    in shared memory."""
    dim_arr = (ctypes.c_int * len(dims))(*dims)

    def ask(name, cs):
        out = ctypes.c_int(0)
        kernels.check(name, kernels.launcher(name)(
            b, len(dims) - 1, ctypes.addressof(dim_arr), cs, ctypes.byref(out)))
        return out.value

    with torch.cuda.device(device):
        cs, shared = k9_plan(p, lambda cs: ask("mlp_fit_words", cs),
                             lambda cs: ask("mlp_fit_max_clusters", cs))
        return cs, None if shared else ask("mlp_fit_words", 1)


def _layer_arrays(dims, layers):
    """ctypes arrays of the layer widths, the init factors and the leaves'
    device pointers, for the launchers."""
    n = len(dims) - 1
    dim_arr = (ctypes.c_int * (n + 1))(*dims)
    scale_arr = (ctypes.c_float * n)(*init_scales(dims))
    w_arr = (ctypes.c_void_p * n)(*(l.w.data_ptr() for l in layers))
    b_arr = (ctypes.c_void_p * n)(*(l.b.data_ptr() for l in layers))
    return dim_arr, scale_arr, w_arr, b_arr


def net_desc(dims, device) -> torch.Tensor | None:
    """The device array a launch of the net ``dims`` passes its layers in
    past :data:`INLINE_LAYERS` (``None`` up to it): room for the w and b
    pointers, the widths and K9's init factors (csrc ``net_desc_bytes``),
    which the launcher writes on the launch's stream."""
    layers = len(dims) - 1
    if layers <= INLINE_LAYERS:
        return None
    return torch.empty((16 * layers + 4 * (layers + 1) + 4 * layers,), dtype=torch.uint8,
                       device=device)


def _check_dims(name, dims):
    if len(dims) < 2:
        raise ValueError(f"{name}: {len(dims) - 1} layers, the kernels take 1 or more")
    if min(dims) < 1:
        raise ValueError(f"{name}: every layer width must be >= 1, got {dims}")


def mlp_fit_args(key, X, y, w, dims, fit_steps, learning_rate, momentum, out, scratch,
                 cs: int = 1):
    """Kernel K9's launch arguments, stream excluded, for checked CUDA
    inputs, preallocated output layers ``out``, the global workspace
    (``None`` when the workspace fits shared memory) and ``cs`` CTAs a
    partition. Returns the ctypes arrays (and past :data:`INLINE_LAYERS`
    the layers' device array) too, which must outlive the call."""
    p, b, _ = X.shape
    dim_arr, scale_arr, w_arr, b_arr = _layer_arrays(dims, out)
    desc = net_desc(dims, X.device)
    args = (key.data_ptr(), X.data_ptr(), y.data_ptr(), w.data_ptr(), p, b,
            len(dims) - 1, ctypes.addressof(dim_arr), ctypes.addressof(scale_arr),
            int(fit_steps), f32(learning_rate), f32(momentum),
            ctypes.addressof(w_arr), ctypes.addressof(b_arr),
            None if desc is None else desc.data_ptr(),
            None if scratch is None else scratch.data_ptr(), int(cs))
    return args, (dim_arr, scale_arr, w_arr, b_arr, desc)


def mlp_fit(key, X, y, w, dims, fit_steps: int = 32, learning_rate: float = 0.05,
            momentum: float = 0.9) -> tuple:
    """The MLP fit of ``X [P, B, F]`` f32, labels ``y [P, B]`` and {0, 1}
    weights ``w [P, B]`` from the fit keys ``key [P, 2]``: a tuple of
    :class:`MLPLayer`.

    CUDA tensors launch kernel K9 (``csrc/mlp_fit.cu``), with the CTAs a
    partition :func:`k9_launch_plan` picks, and add one to
    ``mlp_fit.launches``; CPU tensors run :func:`mlp_fit_reference`."""
    dims = tuple(int(d) for d in dims)
    if X.device.type == "cpu":
        return mlp_fit_reference(key, X, y, w, dims, fit_steps, learning_rate, momentum)
    if X.device.type != "cuda":
        raise ValueError(f"mlp_fit: unsupported device {X.device}")
    _check_dims("mlp_fit", dims)
    if int(fit_steps) < 0:
        raise ValueError(f"mlp_fit: fit_steps must be >= 0, got {fit_steps}")
    dev = X.device
    p, b, f = X.shape
    if f != dims[0]:
        raise ValueError(f"mlp_fit: X has {f} features, the net takes {dims[0]}")
    key = _keys(key).contiguous()
    X = X.float().contiguous()
    y = y.int().contiguous()
    w = w.float().contiguous()
    for name, t, shape in (("key", key, (p, 2)), ("y", y, (p, b)), ("w", w, (p, b))):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"mlp_fit: {name} must be {list(shape)} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    out = tuple(
        MLPLayer(torch.empty((p, din, dout), dtype=torch.float32, device=dev),
                 torch.empty((p, dout), dtype=torch.float32, device=dev))
        for din, dout in zip(dims[:-1], dims[1:])
    )
    cs, words = k9_launch_plan(dev, dims, b, p)
    scratch = (None if words is None else
               torch.empty((p, words), dtype=torch.float32, device=dev))
    args, keep = mlp_fit_args(key, X, y, w, dims, fit_steps, learning_rate, momentum,
                              out, scratch, cs)
    code = kernels.launcher("mlp_fit")(*args, kernels.stream_handle(dev))
    del keep
    kernels.check("mlp_fit", code)
    mlp_fit.launches += 1
    return out


mlp_fit.launches = 0


def mlp_predict_err_reference(params, T, Ty, idx):
    """Plain PyTorch version of :func:`mlp_predict_err`: ``(err, pred)``."""
    i = idx.long()
    f = params[0].w.shape[1]
    pred = _argmax_first(mlp_forward(params, T[i, :f].float()))
    return (pred != Ty[i]).float(), pred


class K10Plan(NamedTuple):
    """Kernel K10's launch plan (csrc/mlp_predict_err.cu ``Plan``)."""

    rows: int  # rows a tile
    threads: int  # a CTA
    ctas: int  # CTAs a partition
    stream: int  # 1: the weights stream through a ring of chunks; 0: resident
    global_: int  # 1: activations and gathered rows in a global workspace
    wa: int  # width of the even layers' activation buffer
    wb: int  # width of the odd layers'
    shared_bytes: int  # a CTA
    global_words: int  # floats of global workspace a CTA (0: none)


# csrc/mlp_predict_err.cu: a thread's tile is 8 rows x 4 units; row tiles
# the plan tries (resident weights at the first K10_RESIDENT of them, then
# streamed at all); the default threads a CTA; floats a buffer of the
# streamed weights' ring.
K10_THREAD_ROWS = 8
K10_ROWS = (128, 64, 32, 16, 8)
K10_RESIDENT = 2
K10_THREADS = 256
K10_RING_WORDS = 4096
K10_MAX_THREADS = 256


def _k10_sizes(dims, rows: int, stream: int, global_: int):
    """(wa, wb, shared words, global words) of K10's plan (csrc/
    mlp_predict_err.cu ``size_plan``): the tile's indices (two buffers of
    ``rows`` ints), then — unless global — the gathered rows [2][F][rows +
    4] and the activations [wa + wb][rows + 4], then the resident weights
    (layer l's w [din][dout rounded up to 4]) or the ring's two buffers."""
    ldr = rows + 4
    wa = max(dims[1::2], default=0)
    wb = max(dims[2::2], default=0)
    acts = (2 * dims[0] + wa + wb) * ldr
    weights = (2 * K10_RING_WORDS if stream
               else sum(din * _r4(dout) for din, dout in zip(dims[:-1], dims[1:])))
    return wa, wb, 2 * _r4(rows) + weights + (0 if global_ else acts), acts if global_ else 0


def k10_plan(dims, p: int, n: int, sms: int, per_sm, rows: int = 0, threads: int = 0,
             ctas: int = 0, stream: int = -1) -> K10Plan:
    """K10's launch plan for ``P = p`` partitions of ``n`` rows through
    the net ``dims`` (csrc/mlp_predict_err.cu ``choose_plan`` and
    ``full_plan``, mirrored so that a plan can be worked out without a
    card): resident weights at the first of ``K10_ROWS[:K10_RESIDENT]``
    rows a tile whose shared memory fits, else streamed weights at the
    first of ``K10_ROWS`` that fits, else activations in a global
    workspace at the largest tile (weights resident if they fit). Then
    the CTAs a partition: ``sms · per_sm(shared_bytes, threads, global_)``
    (the card's SMs times the CTAs an SM holds at once) shared out over
    the ``p`` partitions, at least 1 and at most the partition's tiles.
    ``rows``, ``threads``, ``ctas`` (> 0) and ``stream`` (>= 0) force a
    field. Raises ``ValueError`` when no plan fits."""
    dims = tuple(int(d) for d in dims)
    threads = threads or K10_THREADS
    if threads > K10_MAX_THREADS or threads % 32:
        raise ValueError(f"mlp_predict_err: {threads} threads a CTA; the kernel takes "
                         f"multiples of 32 up to {K10_MAX_THREADS}")
    choices = (rows,) if rows else K10_ROWS
    resident = choices if rows or stream == 0 else choices[:K10_RESIDENT]
    tries = ([(r, 0, 0) for r in resident] if stream != 1 else [])
    tries += [(r, 1, 0) for r in choices] if stream != 0 else []
    tries += [(choices[0], s, 1) for s in (0, 1) if stream in (-1, s)]
    for r, s, g in tries:
        if r < K10_THREAD_ROWS or r % K10_THREAD_ROWS or r // K10_THREAD_ROWS > threads:
            continue
        wa, wb, words, gwords = _k10_sizes(dims, r, s, g)
        if 4 * words <= MAX_SHARED_BYTES:
            break
    else:
        raise ValueError(f"mlp_predict_err: no launch plan for the net {dims} fits "
                         f"{MAX_SHARED_BYTES} B of shared memory (forced rows {rows}, "
                         f"threads {threads}, stream {stream})")
    tiles = -(-max(n, 1) // r)
    if ctas <= 0:
        ctas = max(1, sms * per_sm(4 * words, threads, g) // max(p, 1))
    return K10Plan(r, threads, min(ctas, tiles), s, g, wa, wb, 4 * words, gwords)


# A plan's forced fields, (rows, threads, ctas, stream): none forced.
K10_AUTO = (0, 0, 0, -1)


@functools.cache
def k10_launch_plan(device: torch.device, dims: tuple, p: int, n: int,
                    force: tuple = K10_AUTO) -> K10Plan:
    """K10's plan on ``device`` as the kernel works it out
    (``mlp_predict_err_plan``: the card's SMs and occupancy), once per
    (device, shape, forced fields)."""
    return K10Plan(*k10_kernel_plan(device, dims, p, n, force)[:9])


def k10_kernel_plan(device: torch.device, dims: tuple, p: int, n: int,
                    force: tuple = K10_AUTO) -> tuple:
    """The kernel's own plan (``mlp_predict_err_plan``): the nine fields of
    :class:`K10Plan`, then the card's CTAs an SM for it and its SMs (0, 0
    with ``ctas`` forced)."""
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    out = (ctypes.c_int * 11)()
    with torch.cuda.device(device):
        kernels.check("mlp_predict_err_plan", kernels.launcher("mlp_predict_err_plan")(
            p, n, len(dims) - 1, ctypes.addressof(dim_arr), *force, out))
    return tuple(out)


def k10_force(plan: K10Plan) -> tuple:
    """The forced fields that make the kernel take ``plan`` as it is,
    asking the card nothing: (rows, threads, ctas, stream)."""
    return plan.rows, plan.threads, plan.ctas, plan.stream


def k10_scratch(plan: K10Plan, p: int, device) -> torch.Tensor | None:
    """K10's global workspace for ``plan`` (``None`` when it has none)."""
    if not plan.global_words:
        return None
    return torch.empty((p * plan.ctas * plan.global_words,), dtype=torch.float32, device=device)


def mlp_predict_err_args(params, T, Ty, idx, err, pred=None, scratch=None, force=K10_AUTO):
    """Kernel K10's launch arguments, stream excluded, for checked CUDA
    inputs (``T`` padded by :func:`pad_row_table`), preallocated outputs,
    the plan's global workspace (:func:`k10_scratch`) and the plan's
    forced fields (``K10_AUTO``: none). Returns the ctypes arrays too,
    which must outlive the call."""
    dims = (params[0].w.shape[1], *(layer.w.shape[2] for layer in params))
    dim_arr, _, w_arr, b_arr = _layer_arrays(dims, params)
    desc = net_desc(dims, idx.device)
    args = (T.data_ptr(), T.shape[1], Ty.data_ptr(), idx.data_ptr(), idx.element_size(),
            idx.shape[0], idx.shape[1], len(params), ctypes.addressof(dim_arr),
            ctypes.addressof(w_arr), ctypes.addressof(b_arr),
            None if desc is None else desc.data_ptr(),
            None if scratch is None else scratch.data_ptr(), *force,
            err.data_ptr(), None if pred is None else pred.data_ptr())
    return args, (dim_arr, w_arr, b_arr, desc)


def mlp_predict_err(params, T, Ty, idx, return_pred=False):
    """The MLP's predict fused with the error indicator, over the rows
    ``T[idx]`` of the row table ``T`` — ``[R, F]`` or its padded copy
    ``[R, row_stride(F)]`` — with labels ``Ty [R]`` i32 and gather index
    ``idx [P, N]`` int16 or int32: ``err [P, N]`` f32 (and ``pred``).

    CUDA tensors launch kernel K10 (``csrc/mlp_predict_err.cu``) on the
    plan :func:`k10_launch_plan` works out, and add one to
    ``mlp_predict_err.launches``; CPU tensors run
    :func:`mlp_predict_err_reference`."""
    if idx.device.type == "cpu":
        err, pred = mlp_predict_err_reference(params, T, Ty, idx)
        return (err, pred) if return_pred else err
    if idx.device.type != "cuda":
        raise ValueError(f"mlp_predict_err: unsupported device {idx.device}")
    dev = idx.device
    dims = (params[0].w.shape[1], *(layer.w.shape[2] for layer in params))
    _check_dims("mlp_predict_err", dims)
    f = dims[0]
    if T.shape[1] == f:
        T = pad_row_table(T)
    p, n = idx.shape
    checks = [("T", T, (torch.float32,), (T.shape[0], row_stride(f))),
              ("Ty", Ty, (torch.int32,), (T.shape[0],)),
              ("idx", idx, (torch.int16, torch.int32), (p, n))]
    for l, layer in enumerate(params):
        checks += [(f"w{l}", layer.w, (torch.float32,), (p, dims[l], dims[l + 1])),
                   (f"b{l}", layer.b, (torch.float32,), (p, dims[l + 1]))]
    for name, t, dtypes, shape in checks:
        if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
            raise ValueError(f"mlp_predict_err: {name} must be {'/'.join(map(str, dtypes))} "
                             f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"mlp_predict_err: {name} must be contiguous")
    if T.data_ptr() % 16:
        raise ValueError("mlp_predict_err: T must start on a 16-byte boundary")
    err = torch.empty((p, n), dtype=torch.float32, device=dev)
    pred = torch.empty((p, n), dtype=torch.int32, device=dev) if return_pred else None
    if n == 0 or p == 0:
        return (err, pred) if return_pred else err
    plan = k10_launch_plan(dev, dims, p, n)
    args, keep = mlp_predict_err_args(params, T, Ty, idx, err, pred, k10_scratch(plan, p, dev),
                                      k10_force(plan))
    code = kernels.launcher("mlp_predict_err")(*args, kernels.stream_handle(dev))
    del keep
    kernels.check("mlp_predict_err", code)
    mlp_predict_err.launches += 1
    return (err, pred) if return_pred else err


mlp_predict_err.launches = 0


def make_mlp(spec: ModelSpec, *, hidden=(128, 64), fit_steps: int = 32,
             learning_rate: float = 0.05, momentum: float = 0.9) -> Model:
    """MLP with ReLU hidden layers ``hidden``, fitted with ``fit_steps``
    SGD + momentum steps from ``init(key)``; its ``init`` and ``fit`` take
    the partitions' keys (``keyed``)."""
    dims = (spec.num_features, *(int(h) for h in hidden), spec.num_classes)

    def init(p, device="cpu", key=None):
        if key is None:
            raise ValueError("the mlp's init draws its weights from a key [P, 2]")
        return mlp_init(key, dims, device)

    def fit(X, y, w, key=None):
        if key is None:
            raise ValueError("the mlp's fit draws its init from a key [P, 2]")
        return mlp_fit(key, X, y, w, dims, fit_steps, learning_rate, momentum)

    def predict(params, X):
        return _argmax_first(mlp_forward(params, X))

    def predict_err(params, T, Ty, idx):
        return mlp_predict_err(params, T, Ty, idx)

    return Model("mlp", init, fit, predict, predict_err, keyed=True)
