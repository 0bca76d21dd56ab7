"""Whole-tree checkpoints: `save_checkpoint` / `load_checkpoint` /
`latest_step` (counterpart of apex_tpu/checkpoint/legacy.py), in the JAX
package's pickle layout: ``step_{k}/state.pkl``, a tree of numpy arrays,
so a tree saved by either package loads in the other.

The JAX package writes orbax checkpoints when orbax is installed.  orbax
imports jax, so the port never does: `use_orbax=True` takes the path the
JAX package takes when orbax is missing (a warning, then the pickle), and
an orbax-layout directory is refused with a `CheckpointError` that says
the JAX package reads that format.

A directory in the `checkpoint.sharded` manifest layout is verified for
shard completeness first (a missing or truncated shard raises
`IncompleteCheckpointError` naming the ranks) and returned as its host
fields ({name: tensor | [per-rank tensors]}).
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Any, Optional

import torch

from apex_tpu_torch.checkpoint import sharded as _sh

_ORBAX_NOTE = ("the port writes no orbax checkpoints (orbax imports jax; "
               "the JAX package reads and writes that format)")


def _leaf_to_host(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    try:
        import ml_dtypes
    except ImportError:
        raise _sh.CheckpointError(
            "save_checkpoint: a bfloat16 leaf pickles as an ml_dtypes "
            "array, and ml_dtypes is not installed; cast the leaf, or "
            "use the sharded format (checkpoint.save_sharded), which "
            "writes bf16 without it") from None
    return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)


def _to_host(tree):
    """Every tensor of a tree (dicts, lists, tuples, NamedTuples) as a
    numpy array; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return _leaf_to_host(tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, tree, step: Optional[int] = None,
                    use_orbax: bool = True) -> str:
    """Save a tree as ``state.pkl``; returns the directory written.
    `use_orbax=True` warns that the port writes no orbax checkpoints and
    writes the pickle."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    if use_orbax:
        warnings.warn(
            f"save_checkpoint: {_ORBAX_NOTE}; falling back to the "
            "single-file pickle format", stacklevel=2)
    host = _to_host(tree)
    with open(os.path.join(path, "state.pkl"), "wb") as f:
        pickle.dump(host, f)
    return path


def load_checkpoint(path: str, step: Optional[int] = None,
                    target: Any = None):
    """Restore a tree saved by `save_checkpoint` (either package's
    pickle), or a sharded-manifest directory's host fields."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    if os.path.exists(os.path.join(path, _sh.MANIFEST)):
        if target is not None:
            raise ValueError(
                "load_checkpoint(target=...) is not supported for a "
                "sharded-manifest checkpoint — the field dict has no "
                "single pytree structure to unflatten into; restore "
                "optimizer state through checkpoint.restore_sharded "
                "(which re-lays shards for the target optimizer)")
        manifest = _sh.read_manifest(path)
        # completeness swept cheaply; content crc rides the read that
        # deserializes
        _sh.verify_shards(path, manifest, crc=False)
        return {name: _sh.load_field_host(path, manifest, name,
                                          check_crc=True)
                for name in manifest["fields"]}
    orbax_path = os.path.join(path, "state")
    if os.path.exists(orbax_path):
        raise _sh.CheckpointError(
            f"load_checkpoint: {orbax_path} is an orbax-format "
            f"checkpoint and {_ORBAX_NOTE}; restore it with the JAX "
            "package, or save it there with use_orbax=False")
    pkl = os.path.join(path, "state.pkl")
    try:
        with open(pkl, "rb") as f:
            return pickle.load(f)
    except (EOFError, pickle.UnpicklingError) as e:
        raise _sh.CheckpointError(
            f"{pkl} is truncated or corrupt "
            f"({os.path.getsize(pkl)} bytes): {e!r} — the save was "
            "likely killed mid-write; the sharded format "
            "(checkpoint.CheckpointManager) commits atomically and "
            "names damaged shards instead") from e


def latest_step(path: str) -> Optional[int]:
    """The newest step_N under path (the auto-resume helper)."""
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_"):
            try:
                steps.append(int(d[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None
