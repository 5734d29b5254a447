"""Checkpoint / resume in the JAX package's on-disk format.

Counterpart of ``nthash_tpu/utils/checkpoint.py``, writing the same file: one
``.npz`` with a ``__meta__`` JSON record (``format`` "nthash_tpu.ckpt.v1",
the hash-function name ``fn_name``, the ``leaf_paths`` of every leaf, their
count and a run ``context``) and the leaves as ``leaf_0..leaf_{n-1}``. The
leaf order and path strings are those of ``jax.tree_util`` (dict keys sorted,
``['key']`` / ``.field`` / ``[i]``), computed here without JAX, so a stream
checkpointed by either package resumes in the other.

A state is a tree of dicts, NamedTuples, tuples and lists whose leaves are
torch tensors, numpy arrays or scalars. Loading refuses a checkpoint of a
different hash function, structure, leaf shape or run context.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..constants import NTHASH_FN_NAME

_FORMAT = "nthash_tpu.ckpt.v1"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(state, path: str = ""):
    """-> (list of (key path, leaf), treedef-like string), in JAX order."""
    if isinstance(state, dict):
        items, parts = [], []
        for key in sorted(state):
            sub, desc = _flatten(state[key], f"{path}[{key!r}]")
            items += sub
            parts.append(f"{key!r}: {desc}")
        return items, "{" + ", ".join(parts) + "}"
    if _is_namedtuple(state):
        items, parts = [], []
        for name in state._fields:
            sub, desc = _flatten(getattr(state, name), f"{path}.{name}")
            items += sub
            parts.append(desc)
        kind = type(state).__name__
        return items, f"CustomNode(namedtuple[{kind}], [{', '.join(parts)}])"
    if isinstance(state, (tuple, list)):
        items, parts = [], []
        for i, x in enumerate(state):
            sub, desc = _flatten(x, f"{path}[{i}]")
            items += sub
            parts.append(desc)
        open_, close = ("(", ",)" if len(state) == 1 else ")") \
            if isinstance(state, tuple) else ("[", "]")
        return items, open_ + ", ".join(parts) + close
    if state is None:
        return [], "None"
    return [(path, state)], "*"


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of leaves."""
    if isinstance(like, dict):
        out = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: out[key] for key in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if like is None:
        return None
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path, state, *, context: dict | None = None) -> None:
    """Persist a tree of arrays, tagged with the hash-function name.

    Atomic: writes a temp file in the target directory and ``os.replace``\\ s
    it over ``path``, so a crash mid-save never corrupts an existing
    checkpoint. ``context`` is a JSON-able dict of run parameters that
    :func:`load` can validate via ``expect_context``.
    """
    items, desc = _flatten(state)
    meta = {
        "format": _FORMAT,
        "fn_name": NTHASH_FN_NAME,
        "treedef": f"PyTreeDef({desc})",  # advisory; leaf_paths is the contract
        "leaf_paths": [p for p, _ in items],
        "num_leaves": len(items),
        "context": context or {},
    }
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(items)}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path, like, *, expect_context: dict | None = None):
    """Restore a tree saved by :func:`save` (by either package) into the
    structure of ``like``. Tensor leaves come back as tensors on the device
    of the matching ``like`` leaf, other leaves as numpy arrays of its dtype.

    Raises ValueError for another hash function name, tree structure or leaf
    shape, or if any key of ``expect_context`` differs from the saved
    run context.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("format") != _FORMAT:
            raise ValueError(f"not an nthash_tpu checkpoint: {path}")
        if meta["fn_name"] != NTHASH_FN_NAME:
            raise ValueError(
                f"checkpoint hash function {meta['fn_name']!r} != "
                f"{NTHASH_FN_NAME!r}: persisted hashes are incompatible"
            )
        saved_ctx = meta.get("context", {})
        for key, want in (expect_context or {}).items():
            got = saved_ctx.get(key)
            if got != want:
                raise ValueError(
                    f"checkpoint context mismatch for {key!r}: saved "
                    f"{got!r}, this run has {want!r} — resuming would "
                    "merge state from a different stream configuration"
                )
        leaves = [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    items, _ = _flatten(like)
    want_paths = [p for p, _ in items]
    if meta.get("leaf_paths") != want_paths:
        raise ValueError(
            "checkpoint tree structure does not match the requested state: "
            f"saved leaf paths {meta.get('leaf_paths')!r}, expected "
            f"{want_paths!r}"
        )
    out = []
    for (p, ref), saved in zip(items, leaves):
        want_shape = tuple(getattr(ref, "shape", saved.shape))
        if saved.shape != want_shape:
            raise ValueError(
                f"checkpoint leaf {p} has shape {saved.shape}, "
                f"expected {want_shape}"
            )
        if isinstance(ref, torch.Tensor):
            out.append(torch.from_numpy(np.array(saved)).to(ref.device))
        else:
            out.append(np.asarray(saved, dtype=getattr(ref, "dtype", None)))
    return _unflatten(like, iter(out))
