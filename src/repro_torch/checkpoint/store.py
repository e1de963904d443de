"""Sharded, atomic, restartable checkpointing.

Layout (the JAX package's, ``repro.checkpoint.store``):
  <dir>/step_<N>/          (atomic: written as .tmp_step_<N>, then renamed)
    meta.json              tree structure + shapes + dtypes + step
    leaf_<i>.npy           one file per leaf, numbered in ``jax.tree``'s
                           order (``repro_torch.tree``)

So a checkpoint written by either package restores into the other.
numpy has no bfloat16 without the ``ml_dtypes`` package, so a bfloat16
leaf is written as the JAX package writes it: its two raw bytes per
element under the descr ``<V2`` (what ml_dtypes' bfloat16 gives numpy),
with ``"bfloat16"`` as its dtype in ``meta.json``.  The leaf files are
byte-equal to the JAX package's, and either package's bfloat16 leaf
restores exactly (numpy reads it back as raw bytes).

Guarantees used by the restart manager:
  * a step directory is visible iff it is complete (rename is atomic);
  * ``latest_step`` never returns a partially written checkpoint;
  * ``keep`` bounds disk usage (old steps garbage-collected after a
    successful save).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import describe, leaves, unflatten

BF16 = "bfloat16"


def _save_leaf(path: str, leaf: Any) -> None:
    leaf = torch.as_tensor(leaf).detach().cpu()
    if leaf.dtype != torch.bfloat16:
        np.save(path, leaf.numpy())
        return
    raw = leaf.contiguous().view(torch.int16).numpy().view(np.uint16).view("V2")
    # numpy would write a plain void as "|V2"; the JAX package's file says "<V2"
    with open(path, "wb") as fh:
        np.lib.format.write_array_header_1_0(
            fh, {"descr": "<V2", "fortran_order": False, "shape": raw.shape})
        fh.write(raw.tobytes())


def _tree_meta(tree: Any) -> Dict:
    return {
        "treedef": describe(tree),
        "leaves": [{"shape": list(np.shape(l)),
                    "dtype": str(torch.as_tensor(l).dtype).removeprefix("torch.")}
                   for l in leaves(tree)],
    }


def save(directory: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[Dict] = None) -> str:
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    tree_leaves = leaves(tree)
    for i, leaf in enumerate(tree_leaves):
        _save_leaf(os.path.join(tmp, f"leaf_{i}.npy"), leaf)
    meta = {"step": step, "n_leaves": len(tree_leaves), "extra": extra or {}}
    meta.update(_tree_meta(tree))
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    # GC old checkpoints
    steps = sorted(all_steps(directory))
    for old in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{old}"),
                      ignore_errors=True)
    return final


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            # only complete checkpoints carry meta.json
            if os.path.exists(os.path.join(directory, name, "meta.json")):
                out.append(int(name.split("_", 1)[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _restore_leaf(arr: np.ndarray, stored: str, ref: Any) -> Any:
    if stored == BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    ref = torch.as_tensor(ref)
    return t.to(device=ref.device, dtype=ref.dtype)


def restore(directory: str, step: int, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like``: each leaf a tensor with the
    dtype and device of ``like``'s leaf; a leaf count or shape that differs
    raises ``ValueError``."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    refs = leaves(like)
    if meta["n_leaves"] != len(refs):
        raise ValueError(f"checkpoint holds {meta['n_leaves']} leaves, "
                         f"the tree {len(refs)}")
    out = []
    for i, ref in enumerate(refs):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        want = tuple(np.shape(ref))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, tree {want}")
        out.append(_restore_leaf(arr, meta["leaves"][i]["dtype"], ref))
    return unflatten(like, out), meta.get("extra", {})
