"""Checkpoints of the port's state trees: one ``.npz`` of flattened leaves
and a JSON manifest (the reference's ``repro.checkpoint.store`` layout).

A tree is what the engine's states and outputs are made of: dicts, named
tuples, tuples and lists of tensors, with ``None`` for an absent part
(``RoundState.buffer`` on the sync engine, ``RoundState.warm`` with the
warm start off) and Python numbers
(``round_idx``).  It is flattened as ``engine._map`` walks it, to
``/``-joined key paths (dict keys, named-tuple field names, tuple
indices).  The manifest records each path's dtype and shape, the step
and an ``extra`` dict.  Each file is written under a temporary name and
renamed into place, the manifest first: ``latest_step`` keys on the
``.npz``, so a step counts only once both of its files are complete, and
a host that dies mid-save leaves the previous step as the latest.

Loading restores by key path into the structure of a template tree:
tensors come back bit for bit, with their dtype, on the template leaf's
device (the template's values and shapes are not read); a Python int
(``round_idx``) comes back as an int.  bfloat16 travels as an int16
view, since numpy has no bfloat16.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")

# dtypes numpy cannot hold, and the same-width integer they travel as
_BITCAST = {torch.bfloat16: torch.int16}
# the dtype name of a Python-int leaf (a tensor's is torch's: "float32",
# "bool", ...)
_PY_INT = "py:int"


def _children(node):
    """``(name, child)`` pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def _walk(node, path: str, out: Dict[str, Any]) -> None:
    kids = _children(node)
    if kids is None:
        if node is not None:
            out[path] = node
        return
    for name, child in kids:
        _walk(child, f"{path}/{name}" if path else str(name), out)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    """key path -> (npz-safe array, the leaf's dtype name)."""
    leaves: Dict[str, Any] = {}
    _walk(tree, "", leaves)
    out = {}
    for key, leaf in leaves.items():
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            name = str(t.dtype).replace("torch.", "")
            if t.dtype in _BITCAST:
                t = t.view(_BITCAST[t.dtype])
            out[key] = (t.numpy(), name)
        elif type(leaf) is int:
            out[key] = (np.asarray(leaf), _PY_INT)
        else:
            raise TypeError(f"checkpoint: leaf {key!r} is a "
                            f"{type(leaf).__name__}")
    return out


def _restore(arr: np.ndarray, dtype_name: str, like):
    if dtype_name == _PY_INT:
        return int(arr.item())
    t = torch.from_numpy(np.array(arr))
    dtype = getattr(torch, dtype_name)
    if dtype in _BITCAST:
        t = t.view(dtype)
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` as ``step_<step>.npz`` and its manifest
    ``step_<step>.json`` in ``directory`` (made if missing); returns the
    npz path."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    manifest = {
        "step": int(step),
        "keys": {k: {"dtype": dt, "shape": list(v.shape)}
                 for k, (v, dt) in flat.items()},
        "extra": extra or {},
    }
    mpath = os.path.join(directory, f"step_{step}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    path = os.path.join(directory, f"step_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp, "wb") as fh:     # a file handle: savez appends no .npz
        np.savez(fh, **{k: v for k, (v, _) in flat.items()})
    os.replace(tmp, path)           # the step is complete from here on
    return path


def _rebuild(node, path: str, load):
    kids = _children(node)
    if kids is None:
        return None if node is None else load(path, node)
    vals = [_rebuild(child, f"{path}/{name}" if path else str(name), load)
            for name, child in kids]
    if isinstance(node, dict):
        return dict(zip(node.keys(), vals))
    if hasattr(node, "_fields"):
        return type(node)(*vals)
    return type(node)(vals)


def load_checkpoint(directory: str, template, step: Optional[int] = None
                    ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore the checkpoint of ``step`` (default: the latest) into the
    structure of ``template``.  Returns ``(tree, step, extra)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with open(os.path.join(directory, f"step_{step}.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, f"step_{step}.npz")) as data:
        def load(key, like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            want = manifest["keys"][key]
            arr = data[key]
            if list(arr.shape) != want["shape"]:
                raise ValueError(f"checkpoint leaf {key!r}: shape "
                                 f"{arr.shape} != {want['shape']}")
            return _restore(arr, want["dtype"], like)
        tree = _rebuild(template, "", load)
    return tree, int(manifest["step"]), manifest.get("extra", {})


def latest_step(directory: str) -> Optional[int]:
    """The largest ``n`` of a ``step_<n>.npz`` in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _STEP_RE.match(f))]
    return max(steps) if steps else None
