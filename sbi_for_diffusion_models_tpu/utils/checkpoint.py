"""Training checkpoint/resume in the tree-path ``.npz`` format.

The reference's persistence is broken (save/load filename mismatch, loading
from an untrained trainer; reference src/sbi_for_diffusion_models/mnle.py:
247-297, README.md:66,86-87) and a crash mid-run loses everything (SBC
results held in Python lists, reference mnle.py:179-216). This module is the
training-resume tier: the full state (params + optimizer + epoch + RNG key +
config fingerprint) is written as one ``.npz`` per checkpoint, each leaf
under its ``jax.tree_util.keystr`` path — the format ``mnle.save_model``
uses — and restored into the tree structure of a freshly built state.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Optional

import jax
import numpy as np

__all__ = [
    "config_fingerprint",
    "save_train_state",
    "restore_train_state",
    "latest_step",
]

_KEEP = 3  # newest checkpoints kept per directory


def config_fingerprint(cfg) -> str:
    """Stable hash of a (dataclass) config for checkpoint compatibility checks."""
    blob = json.dumps(
        {k: repr(v) for k, v in sorted(cfg.__dict__.items())}, sort_keys=True
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _steps(directory: Path) -> list[int]:
    if not directory.is_dir():
        return []
    return sorted(
        int(p.stem.split("_")[1]) for p in directory.glob("step_*.npz")
    )


def _path(directory: Path, step: int) -> Path:
    return directory / f"step_{step:08d}.npz"


def save_train_state(
    directory: str | Path,
    step: int,
    params: Any,
    opt_state: Any,
    key: jax.Array,
    cfg=None,
    extra: Optional[dict] = None,
) -> None:
    """Checkpoint full training state at `step` (epoch)."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    state = {
        "params": params,
        "opt_state": opt_state,
        "key": jax.random.key_data(key),
        "meta": {"step": np.asarray(step, np.int64)},
    }
    if extra:
        state["extra"] = extra
    leaves = {
        jax.tree_util.keystr(kp): np.asarray(leaf)
        for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]
    }
    # Atomic: a crash mid-write never leaves a truncated checkpoint.
    tmp = directory / f".step_{step:08d}.tmp.npz"
    np.savez(tmp, **leaves)
    os.replace(tmp, _path(directory, step))
    for old in _steps(directory)[:-_KEEP]:
        _path(directory, old).unlink(missing_ok=True)
    if cfg is not None:
        (directory / "config_fingerprint.txt").write_text(config_fingerprint(cfg))


def latest_step(directory: str | Path) -> Optional[int]:
    steps = _steps(Path(directory).absolute())
    return steps[-1] if steps else None


def restore_train_state(
    directory: str | Path,
    abstract_state: dict,
    step: Optional[int] = None,
    cfg=None,
) -> Optional[dict]:
    """Restore training state; returns None when no checkpoint exists.

    ``abstract_state`` must have the same tree structure / shapes / dtypes as
    what was saved (build it from a fresh init). When ``cfg`` is given, a
    fingerprint mismatch raises instead of silently resuming with different
    hyperparameters.
    """
    directory = Path(directory).absolute()
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None
    if cfg is not None:
        fp_file = directory / "config_fingerprint.txt"
        if fp_file.exists() and fp_file.read_text() != config_fingerprint(cfg):
            raise ValueError(
                f"checkpoint at {directory} was written with a different "
                "config; refusing to resume (delete the directory to restart)"
            )
    with np.load(_path(directory, step), allow_pickle=False) as data:
        flat, treedef = jax.tree_util.tree_flatten_with_path(abstract_state)
        leaves = []
        for kp, like in flat:
            value = data[jax.tree_util.keystr(kp)]
            if value.shape != np.shape(like):
                raise ValueError(
                    f"checkpoint leaf {jax.tree_util.keystr(kp)} has shape "
                    f"{value.shape}, expected {np.shape(like)}"
                )
            leaves.append(value.astype(np.asarray(like).dtype, copy=False))
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    state["key"] = jax.random.wrap_key_data(jax.numpy.asarray(state["key"]))
    return state
