"""Checkpoints of nested dicts (and lists) of tensors, in the on-disk format
of ``repro.checkpoint.store``: one ``arrays.npz`` of leaves keyed by their
``/``-joined paths, plus a JSON ``manifest.json``.

Leaves are pulled to the host.  Types that ``.npz`` cannot hold
(bfloat16, fp8) are upcast to float32 on disk and named in
``manifest["dtypes"]``, and cast back on restore (bf16 -> float32 is
exact).  Dict keys are flattened in sorted order, as JAX flattens a dict,
so each package restores what the other saved.  Restores are keyed by
path: partially overlapping trees fail loudly.

``CheckpointManager`` adds ``step_N`` directories, atomic
write-then-rename, keep-last-k GC and latest-step discovery.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

# torch dtypes that .npz stores losslessly; anything else is upcast to
# float32 on disk and named in the manifest
_NATIVE = {torch.float64, torch.float32, torch.float16, torch.int64,
           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
           torch.complex64, torch.complex128}


def _flatten(tree, prefix=()) -> List[Tuple[str, Any]]:
    """(path key, leaf) pairs, dict keys sorted, list items by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _treedef(tree) -> str:
    """The tree's shape as JAX's ``str(treedef)`` writes it (informative
    only: neither package reads it back)."""
    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(v) for v in node)
            return f"[{inner}]" if isinstance(node, list) else f"({inner})"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """-> (array for the .npz, the dtype name to restore, or None)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = leaf.detach().cpu()
    if t.dtype in _NATIVE:
        return t.numpy(), None
    return t.float().numpy(), str(t.dtype).removeprefix("torch.")


def save(directory: str, tree: Any) -> None:
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    manifest = {"keys": [], "dtypes": {}, "treedef": _treedef(tree)}
    for key, leaf in _flatten(tree):
        arr, dtype = _to_numpy(leaf)
        if dtype is not None:
            manifest["dtypes"][key] = dtype
        arrays[key] = arr
        manifest["keys"].append(key)
    tmp = tempfile.mkdtemp(dir=directory)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        for name in ("arrays.npz", "manifest.json"):
            os.replace(os.path.join(tmp, name), os.path.join(directory, name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint names dtype {name!r}, which torch "
                         "does not have")
    return dt


def restore(directory: str, like: Any) -> Any:
    """Restore into the structure of ``like``: shapes and dtypes come from
    disk (keys must match exactly); each leaf lands on the device of the
    tensor it replaces in ``like`` (the CPU for any other leaf)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(directory, "arrays.npz")) as data:
        flat = _flatten(like)
        stored = set(data.files)
        wanted = {k for k, _ in flat}
        if stored != wanted:
            missing = sorted(wanted - stored)[:5]
            extra = sorted(stored - wanted)[:5]
            raise ValueError(
                f"checkpoint/tree mismatch: missing={missing} extra={extra}")
        leaves = {}
        for key, old in flat:
            t = torch.from_numpy(data[key])
            if key in dtypes:
                t = t.to(_torch_dtype(dtypes[key]))
            device = old.device if isinstance(old, torch.Tensor) else "cpu"
            leaves[key] = t.to(device)

    def build(node, prefix=()):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        return leaves["/".join(prefix)]

    return build(like)


_STEP_RE = re.compile(r"^step_(\d+)$")


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(m.group(1)) for d in os.listdir(root)
             if (m := _STEP_RE.match(d))
             and os.path.exists(os.path.join(root, d, "manifest.json"))]
    return max(steps) if steps else None


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def dir_for(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def save(self, step: int, tree: Any) -> None:
        save(self.dir_for(step), tree)
        self._gc()

    def restore_latest(self, like: Any):
        step = latest_step(self.root)
        if step is None:
            return None, None
        return step, restore(self.dir_for(step), like)

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.root)
            if (m := _STEP_RE.match(d)))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir_for(s), ignore_errors=True)
