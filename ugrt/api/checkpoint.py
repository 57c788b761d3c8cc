"""Checkpoint / resume for inverse-rendering state.

The reference has no checkpointing (SURVEY.md §5); the closest artifact
is its per-frame PPM dump.  The framework optimizes scene parameters
(vertices, materials) over many steps, so checkpointing is a first-class
design requirement.  Checkpoints are plain .npz files, one per step,
holding the state's leaves under their '/'-joined tree paths.
"""

from __future__ import annotations

import os

import jax
import numpy as np

def save_checkpoint(path: str, state: dict, step: int) -> str:
    """Save a pytree-of-arrays state dict.  Returns the written path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"step_{step}.npz")
    flat = {}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(state)
    for keypath, leaf in leaves:
        key = "/".join(
            str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
            for k in keypath)
        flat[key] = np.asarray(leaf)
    np.savez(fn, **flat)
    return fn


def load_checkpoint(path: str, step: int | None = None) -> dict:
    """Load the given (or latest) step of a checkpoint directory, or one
    .npz file.  Returns a flat {name: array} dict."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.endswith(".npz"))
        assert files, f"no checkpoints under {path}"
        if step is not None:
            fn = os.path.join(path, f"step_{step}.npz")
        else:
            fn = os.path.join(
                path, max(files, key=lambda f: int(f[5:-4])))
    else:
        fn = path
    with np.load(fn) as data:
        return {k: data[k] for k in data.files}


def latest_step(path: str) -> int | None:
    """Highest checkpointed step under path, or None."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and d.endswith(".npz"):
            try:
                steps.append(int(d[5:-4]))
            except ValueError:
                pass
    return max(steps) if steps else None
