"""Parameter tree <-> flat 1-D buffer mapping (counterpart of
apex_tpu/optimizers/flat.py).

The training step keeps every parameter in one flat buffer that the
fused optimizer kernel updates in a single pass; the model reads its
weights as views into that buffer.

Leaf order is the JAX package's: `jax.tree_util` visits dict keys in
sorted order, so `block10` comes before `block2`, `fc1` before `qkv`
and `bias` before `weight`.  The same tree therefore flattens to the
same buffer in both packages, element for element, and a spec carries
the key path of each leaf so `unflatten` can rebuild the nested dict.
Trees are nested dicts of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static description of the tree's layout inside the flat buffer.

    `paths` holds each leaf's key path (a tuple of dict keys) in leaf
    order.  With ``align > 1`` every leaf's segment is
    rounded up to a multiple of `align` elements (zero-filled tail)."""

    paths: Tuple[Tuple[Any, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    align: int = 1


def tree_leaves_with_paths(tree, prefix=()):
    """(path, leaf) pairs in the JAX package's leaf order: dict keys
    sorted."""
    if isinstance(tree, Mapping):
        out = []
        for key in sorted(tree):
            out += tree_leaves_with_paths(tree[key], prefix + (key,))
        return out
    return [(prefix, tree)]


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_paths(tree)]


def make_spec(tree, align: int = 1) -> FlatSpec:
    pairs = tree_leaves_with_paths(tree)
    shapes = tuple(tuple(leaf.shape) for _, leaf in pairs)
    sizes = tuple(int(leaf.numel()) for _, leaf in pairs)
    padded = [-(-s // align) * align for s in sizes]
    offsets, off = [], 0
    for p in padded:
        offsets.append(off)
        off += p
    return FlatSpec(paths=tuple(path for path, _ in pairs), shapes=shapes,
                    dtypes=tuple(leaf.dtype for _, leaf in pairs),
                    sizes=sizes, offsets=tuple(offsets), total=off,
                    align=align)


def flatten(tree, dtype=torch.float32, pad_to: int = 1, align: int = 1):
    """Concatenate all leaves (cast to `dtype`) into one 1-D buffer: one
    `torch.cat` (a list of tensors is taken as leaves in its order).
    `align` zero-pads every leaf's segment to a multiple
    (it must match the spec's align); `pad_to` rounds the buffer length
    up to a multiple, so the optimizer kernel sees whole tiles and
    updates in place.  `unflatten` ignores all padding."""
    leaves = list(tree) if isinstance(tree, list) else tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=dtype)
    parts = []
    for leaf in leaves:
        part = leaf.reshape(-1).to(dtype)
        pad = (-part.numel()) % align
        if pad:
            part = torch.cat([part, part.new_zeros(pad)])
        parts.append(part)
    n = sum(p.numel() for p in parts)
    pad = (-n) % pad_to
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def unflatten_leaves(flat, spec: FlatSpec, cast_to_leaf_dtype: bool = True):
    """The leaves of `spec` read out of a flat buffer, in leaf order.
    Where a leaf's dtype is the buffer's (or `cast_to_leaf_dtype` is
    False) the leaf is a VIEW into the buffer, so an in-place optimizer
    update is seen by the model with no copy; otherwise it is a cast
    copy."""
    leaves = []
    for shape, dt, size, off in zip(spec.shapes, spec.dtypes, spec.sizes,
                                    spec.offsets):
        leaf = flat[off:off + size].view(shape)
        if cast_to_leaf_dtype and dt != flat.dtype:
            leaf = leaf.to(dt)
        leaves.append(leaf)
    return leaves


def tree_from_leaves(spec: FlatSpec, leaves):
    """The nested tree of `spec`'s key paths holding `leaves`."""
    if len(spec.paths) == 1 and not spec.paths[0]:
        return leaves[0]
    tree = {}
    for path, leaf in zip(spec.paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def unflatten(flat, spec: FlatSpec, cast_to_leaf_dtype: bool = True):
    """Rebuild the nested tree from a flat buffer (leaves are views where
    the dtypes agree, see `unflatten_leaves`)."""
    return tree_from_leaves(spec, unflatten_leaves(flat, spec,
                                                   cast_to_leaf_dtype))


def per_leaf_scalars(tree, params, who: str) -> np.ndarray:
    """A per-leaf scalar tree (bools or floats: the wd_mask of
    `get_params_for_weight_decay_optimization`, per-leaf lr multipliers)
    as an (n_leaves,) fp32 vector in the params' leaf order.  The tree's
    key paths must be the params' exactly: a tree with the same number
    of leaves under other keys would hand hyperparameters to the wrong
    tensors."""
    got = tree_leaves_with_paths(tree)
    want = [path for path, _ in tree_leaves_with_paths(params)]
    if [path for path, _ in got] != want:
        raise ValueError(
            f"{who}: per-leaf tree structure/leaves do not match the params "
            f"tree ({[p for p, _ in got]} vs {want}): build it over the same "
            "params tree")
    return np.asarray([float(x) for _, x in got], np.float32)


def resolve_per_leaf(wd_mask, lr_scales, weight_decay: float, params,
                     who: str):
    """(seg_wd, seg_lrs), fp32 vectors in leaf order: wd_mask leaves
    multiply `weight_decay` (bool → 0/1), lr_scales leaves multiply the
    learning rate; an absent tree gives the uniform value."""
    n = len(tree_leaves(params))
    seg_wd = (weight_decay * per_leaf_scalars(wd_mask, params, who)
              if wd_mask is not None
              else np.full((n,), weight_decay, np.float32))
    seg_lrs = (per_leaf_scalars(lr_scales, params, who)
               if lr_scales is not None else np.ones((n,), np.float32))
    return seg_wd, seg_lrs


def layout_dict(spec: FlatSpec) -> dict:
    """The layout fingerprint kept in optimizer state_dicts, so that a
    checkpoint written under one flat layout cannot be restored into
    another (buffer lengths often coincide after FLAT_TILE rounding, so
    a shape check alone cannot tell)."""
    return {"align": spec.align, "total": spec.total,
            "n_tensors": len(spec.sizes)}


def check_layout(spec: FlatSpec, d: dict, who: str) -> None:
    """Refuse a state dict `d` whose recorded layout is not `spec`'s.  A
    dict without a record (written before layouts were recorded) is
    taken only for an unaligned spec, and only if its params buffer
    covers spec.total."""
    lay = d.get("flat_layout")
    if lay is None:
        if spec.align != 1:
            raise ValueError(
                f"{who}: checkpoint has no flat_layout record but the "
                f"current spec is align={spec.align}; offsets would not "
                "match — re-save the checkpoint with this version")
        arr = d.get("params")
        shape = tuple(getattr(arr, "shape", ()))
        if arr is not None and len(shape) == 1 and int(shape[0]) < spec.total:
            raise ValueError(
                f"{who}: pre-layout checkpoint buffer has {int(shape[0])} "
                f"elements < spec total {spec.total} — wrong layout or "
                "truncated")
        return
    want = layout_dict(spec)
    if {k: int(lay[k]) for k in want} != want:
        raise ValueError(
            f"{who}: checkpoint flat layout {lay} does not match the "
            f"current spec {want}")


def _as_tensor(x, device):
    """A tensor, numpy array (bf16 ones included) or number as a tensor
    on `device`.  Arrays are copied: the optimizer updates its state in
    place, and an array (a JAX one read through numpy) is not its to
    write."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":        # numpy has no bf16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


class FlatCheckpointMixin:
    """Checkpoints of a flat-buffer optimizer (≡ the JAX package's
    `FlatCheckpointMixin`).  The state is a NamedTuple of tensors (`step`
    and flat buffers); subclasses set `_STATE`, and `init` sets `spec`
    and `device`.  `state_dict` embeds the layout fingerprint and holds
    the state's own tensors, which the next step updates in place (as a
    torch optimizer's does: save it before stepping on).
    `load_state_dict` refuses before `init()` (without a spec the layout
    cannot be checked) and rebuilds the state on the optimizer's device,
    with `step` as int32.  Tensors and numpy arrays are both taken."""

    _STATE = None
    spec: Optional[FlatSpec] = None
    device: Optional[torch.device] = None

    def state_dict(self, state) -> dict:
        d = dict(state._asdict())
        d["flat_layout"] = layout_dict(self.spec)
        return d

    def load_state_dict(self, d: dict):
        if self.spec is None:
            raise ValueError(
                f"{type(self).__name__}.load_state_dict called before "
                "init(); call init(params) first so the checkpoint's "
                "flat layout can be validated")
        check_layout(self.spec, d, type(self).__name__)
        fields = {k: _as_tensor(v, self.device) for k, v in d.items()
                  if k != "flat_layout"}
        if "step" in fields:
            fields["step"] = fields["step"].to(torch.int32).reshape(())
        return type(self)._STATE(**fields)
