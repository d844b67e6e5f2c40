"""Checkpoint/resume of a carried state (the chained soak's).

The port's twin of the JAX package's ``utils/checkpoint.py``. The state is
a tree of NamedTuples and tuples whose leaves are tensors (on any device)
or numpy arrays — the port's keys are uint32 numpy arrays already, where
the JAX package stores its typed keys' key data. It is saved as a flat
``.npz`` of the leaves in tree order plus JSON metadata; ``None`` entries
are no leaves, as in a JAX pytree. Loading needs a template of the same
structure (rebuild the chain with the same config, then restore): tensor
leaves come back on the template's device and dtype.

:func:`save_checkpoint` is atomic — a same-directory temp file, fsync,
``os.replace`` — so a crash mid-write (the injected ``checkpoint.save``
fault included) tears only the temp file, never a good checkpoint.
:func:`load_checkpoint` turns the parse errors a torn file gives into
:class:`CheckpointCorruptError` naming the path.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from ..resilience import faults


class CheckpointCorruptError(RuntimeError):
    """The checkpoint file is torn or corrupt (crash mid-write on a
    pre-atomic writer, bit rot, truncation). Subclasses ``RuntimeError``
    — a retry policy classifies it transient, but the standard recovery
    is to delete the file and restart the chain from scratch."""


def _flatten(tree) -> list:
    """The leaves of ``tree`` in order: NamedTuples, tuples and lists are
    nodes, ``None`` is empty, anything else a leaf."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in _flatten(node)]
    return [tree]


def _unflatten(template, leaves):
    """``template`` with its leaves replaced, in order, from the iterator
    ``leaves`` (each converted by the caller)."""
    if template is None:
        return None
    if isinstance(template, (tuple, list)):
        nodes = [_unflatten(node, leaves) for node in template]
        if hasattr(template, "_fields"):
            return type(template)(*nodes)
        return type(template)(nodes)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree, meta: dict | None = None) -> None:
    """Atomically persist ``tree`` (+ JSON-able ``meta``) to ``path``:
    write, flush, fsync, ``os.replace``. The temp file lives in the
    target's directory, so the rename stays on one filesystem."""
    arrays = {f"leaf_{i}": _to_host(leaf) for i, leaf in enumerate(_flatten(tree))}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    # Fault-injection site (no-op unless armed): a kill between write and
    # rename — kind='torn_write' truncates the temp file mid-byte first.
    faults.fire("checkpoint.save", file=tmp, path=path)
    os.replace(tmp, path)


def load_checkpoint(path: str, template) -> tuple[object, dict]:
    """Restore a tree with the structure, shapes and dtypes of
    ``template``. A file that cannot be parsed as a checkpoint archive
    raises :class:`CheckpointCorruptError`; a structural disagreement with
    the template (leaf count, shapes) stays ``ValueError``."""
    try:
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            leaves = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    # Only parse-shaped failures mean corruption; genuine I/O errors
    # propagate as themselves.
    except (zipfile.BadZipFile, EOFError, KeyError,
            json.JSONDecodeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"torn/corrupt checkpoint {path!r}: cannot parse it as a saved "
            f"state archive ({type(e).__name__}: {e}) — it was likely cut "
            "off mid-write by a crash; delete it to restart from scratch"
        ) from e
    want = _flatten(template)
    if len(want) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has {len(want)}"
        )
    restored = []
    for got, like in zip(leaves, want):
        shape = tuple(like.shape)
        if got.shape != shape:
            raise ValueError(f"checkpoint leaf shape {got.shape} != template {shape}")
        if isinstance(like, torch.Tensor):
            dtype = torch.empty((), dtype=like.dtype).numpy().dtype
            restored.append(torch.from_numpy(got.astype(dtype)).to(like.device))
        else:
            restored.append(got.astype(np.asarray(like).dtype))
    return _unflatten(template, iter(restored)), meta
