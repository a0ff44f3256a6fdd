"""Checkpoint/resume: atomic versioned pytree checkpoints.

(ref: SURVEY.md §5 — the reference checkpoints by writing $dir/$x.mdl every
 outer iteration and resumes via --stage flags; the equivalent here is
 checkpoint-every-N-steps with atomic writes (write-temp + rename) and
 latest-step discovery. Arrays are stored as npz; the pytree structure as
 JSON-encoded paths, so checkpoints are inspectable without the model code.)
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import jax


def _savable(arr: np.ndarray) -> np.ndarray:
    """np.savez silently stores ml_dtypes leaves (bfloat16/fp8) as raw
    void arrays that np.load cannot interpret — upcast them losslessly
    to float32 for storage; load_checkpoint(like=...) casts back."""
    if arr.dtype.kind not in "biufc":
        return arr.astype(np.float32)
    return arr


def _flatten(tree):
    flat = jax.tree_util.tree_leaves_with_path(tree)
    return {jax.tree_util.keystr(path): _savable(np.asarray(leaf))
            for path, leaf in flat}


def save_checkpoint(ckpt_dir: str, step: int, tree, keep: int = 3,
                    extra: dict | None = None) -> str:
    """Atomically write checkpoint `step`; prune to the newest `keep`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "╱"): v for k, v in flat.items()})
        meta = {"step": step, "keys": sorted(flat.keys()),
                "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            # default=str: numpy/JAX scalars in `extra` (losses etc.)
            # must not abort the checkpoint mid-training
            json.dump(meta, f, default=str)
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # prune old checkpoints
    steps = sorted(list_checkpoints(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
    return final


def list_checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d{10})", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def load_checkpoint(ckpt_dir: str, step: int | None = None,
                    like=None):
    """-> (step, flat dict path->array | pytree shaped like `like`, extra).
    step=None loads the newest."""
    steps = list_checkpoints(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    arrs = np.load(os.path.join(d, "arrays.npz"))
    flat = {k.replace("╱", "/"): arrs[k] for k in arrs.files}
    if like is not None:
        like_flat = jax.tree_util.tree_leaves_with_path(like)
        paths = [jax.tree_util.keystr(p) for p, _l in like_flat]
        # restore non-native dtypes (bf16/fp8 stored as f32 — see _savable)
        leaves = [flat[p].astype(np.asarray(l).dtype)
                  if np.asarray(l).dtype != flat[p].dtype else flat[p]
                  for p, (_kp, l) in zip(paths, like_flat)]
        tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(like), leaves)
        return step, tree, meta.get("extra", {})
    return step, flat, meta.get("extra", {})
