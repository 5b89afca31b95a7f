"""Fault-tolerant checkpoints in the JAX package's layout.

Layout per step::

    <dir>/step_000000123/
        shard_00000.npz        # flat {index -> array}
        MANIFEST.json          # tree paths, shapes, dtypes, step
    <dir>/LATEST               # atomic pointer file (write-tmp + rename)

* **atomic**: the step directory is written under ``.tmp`` and renamed,
  then ``LATEST`` is replaced, so a crash mid-save never corrupts the
  restore point; the oldest steps beyond ``keep`` are removed;
* **self-describing**: the manifest stores the flattened tree paths,
  which are the strings ``jax.tree_util.tree_flatten_with_path`` gives
  (``['params']/['w_in']``, ``['opt']/.mu/['layers']/['w']``), so a
  checkpoint written by either package restores in the other.

Arrays are saved as whole host arrays in one shard.  A bfloat16 leaf is
saved as its 16-bit pattern (numpy has no bfloat16) under the dtype name
``bfloat16``, and restored from either package's file by that name; the
JAX package reads such a leaf back as uint16.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from .tree import flatten_with_paths, unflatten

SHARD_FILE = "shard_{idx:05d}.npz"
MANIFEST = "MANIFEST.json"
LATEST = "LATEST"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def save(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Write a checkpoint; returns its path. Atomic via rename."""
    step_dir = os.path.join(directory, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)

    flat = flatten_with_paths(tree)
    arrays, dtypes = {}, []
    for i, (_, leaf) in enumerate(flat):
        arrays[str(i)], dtype = _to_numpy(leaf)
        dtypes.append(dtype)
    np.savez(os.path.join(tmp_dir, SHARD_FILE.format(idx=0)), **arrays)

    manifest = {
        "step": step,
        "paths": [p for p, _ in flat],
        "dtypes": dtypes,
        "shapes": [list(a.shape) for a in arrays.values()],
        "n_shards": 1,
    }
    with open(os.path.join(tmp_dir, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)

    latest_tmp = os.path.join(directory, LATEST + ".tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(step_dir))
    os.replace(latest_tmp, os.path.join(directory, LATEST))

    _gc(directory, keep)
    return step_dir


def _gc(directory: str, keep: int):
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    pointer = os.path.join(directory, LATEST)
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name, MANIFEST)):
        return None
    return int(name.split("_")[1])


def restore(directory: str, tree_like, *, step: int | None = None,
            device=None):
    """Restore into the structure of ``tree_like``; returns ``(tree,
    step)``.

    Each leaf goes to ``device`` when given, else to the device of the
    matching leaf of ``tree_like`` (the CPU for a leaf that is no
    tensor), in the dtype the checkpoint holds.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    step_dir = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(step_dir, MANIFEST)) as f:
        manifest = json.load(f)
    flat = flatten_with_paths(tree_like)
    ref_paths = [p for p, _ in flat]
    if ref_paths != manifest["paths"]:
        raise ValueError(
            "checkpoint tree mismatch: "
            f"{set(ref_paths) ^ set(manifest['paths'])}"
        )
    out = []
    with np.load(os.path.join(step_dir, SHARD_FILE.format(idx=0))) as data:
        for i, (_, like) in enumerate(flat):
            dev = device if device is not None else (
                like.device if torch.is_tensor(like) else "cpu")
            out.append(_to_tensor(data[str(i)], manifest["dtypes"][i], dev))
    return unflatten(tree_like, out), step
