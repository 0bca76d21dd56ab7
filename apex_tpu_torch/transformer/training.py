"""The tensor- and data-parallel training step (counterpart of
apex_tpu/transformer/training.py:33-160).

The optimizer state owns the parameters: its flat buffer is the master
copy and the model reads its weights as views into it (`flat.unflatten`
views when the master dtype is the model's, cast copies otherwise).  A
step is the JAX package's shape: per-leaf gradients of the loss, one
concatenate into the padded flat gradient buffer, then one fused
optimizer pass (`step_flat`) that updates the buffers in place.  No
`torch.cuda.synchronize()` and no `.item()` inside the step: the loss
comes back as a device tensor.

Across ranks the groups are `parallel.mesh`'s ((pp, dp, tp), tp
innermost, as the JAX mesh is laid out).  Each rank's optimizer state
holds its pp and tp shard of the parameters (`init_sharded_optimizer`
cuts it by the model's `partition_specs()`), so the flat buffer of the
rank at stage pp_i and tp rank tp_i is row pp_i·tp + tp_i of the JAX
package's `P(("pp", "tp"))` state buffer.  The model's tp and pp
collectives run inside autograd.  For a pipelined model
(`pp_partial_grads`) the leaves every stage holds a copy of (the tied
embedding, the positions, the final LayerNorm) get partial gradients on
each stage; one all-reduce over the pp group sums them, so every
stage's copy takes the same step (≡ the reference's embedding-group
all-reduce).  Then the flat gradient is averaged over the dp group (one
all-reduce), and so is the returned loss.  Without a mesh and without
torch.distributed this is the single-device step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.optimizer_kernels import FLAT_TILE
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    axis_dims, shard_tree_axes)


def _to_device(tree, dev):
    """A tree of tensors (tuples, lists and dicts of them) moved to `dev`,
    as the JAX steps take a pytree of labels or a batch."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(t, dev) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree


def _coords():
    """{axis: (this rank's index, size)} over the pp and tp groups."""
    return {ax: (M.group_rank(g), M.group_size(g))
            for ax, g in ((M.PP_AXIS, M.group_of(M.PP_AXIS)),
                          (M.TP_AXIS, M.group_of(M.TP_AXIS)))}


def init_sharded_optimizer(optimizer, model, params):
    """Optimizer state over this rank's shards of the global `params`
    (the JAX package's: it takes the global tree and `shard_map` hands
    each rank its shard), cut by `model.partition_specs()` over the pp
    and tp groups; without them, over all of them.  The state holds its
    own copy of the parameters."""
    coords = _coords()
    if any(size > 1 for _, size in coords.values()):
        params = shard_tree_axes(params, model.partition_specs(), coords)
    return optimizer.init(params)


def _leaf_spec(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def make_tp_dp_train_step(model, optimizer, *,
                          loss_fn: Optional[Callable] = None, device=None,
                          pp_partial_grads: Optional[bool] = None):
    """Returns step(opt_state, tokens, labels) -> (opt_state, loss).

    `loss_fn(params, tokens, labels)` defaults to `model.loss`; `labels`
    may be a tensor or a tuple or list of tensors (BERT passes
    (mlm_labels, loss_mask, nsp_labels)), moved to the device as it is.
    `tokens` and `labels` are this rank's share of the batch (the dp
    group splits it; the tp and pp ranks of a dp rank see the same).
    The step takes per-leaf gradients of the local loss, sums the
    pp-replicated leaves' over the pp group when `pp_partial_grads`
    (None: inferred from the model's `pp` / `pipeline_parallel_size`
    above 1, as the JAX package does), averages them over the dp group
    of `parallel.mesh` (the world without a mesh; none without
    torch.distributed), and makes one fused optimizer pass over the
    rank's shard.  It runs on `device`: the card unless the caller asks
    for the CPU (`device="cpu"`, the plain versions of the kernels)."""
    dev = resolve_device(device)
    lf = loss_fn or model.loss
    if pp_partial_grads is None:
        pp_partial_grads = max(getattr(model, "pp", 1),
                               getattr(model, "pipeline_parallel_size",
                                       1)) > 1
    specs = model.partition_specs() if pp_partial_grads else None

    def step(opt_state, tokens, labels):
        spec = optimizer.spec
        if spec is None:
            raise RuntimeError("build the state with init_sharded_optimizer "
                               "before stepping")
        if opt_state.params.device != dev:
            raise ValueError(f"optimizer state lives on "
                             f"{opt_state.params.device}, the step on {dev}")
        leaves = [leaf.detach().requires_grad_(True)
                  for leaf in F.unflatten_leaves(opt_state.params, spec)]
        params = F.tree_from_leaves(spec, leaves)
        loss = lf(params, tokens.to(dev), _to_device(labels, dev))
        # a leaf the loss does not read (BERT's token types when none
        # are given) gets a zero gradient, as under jax.grad
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        if pp_partial_grads:
            _sum_over_pp(grads, [
                M.PP_AXIS not in axis_dims(_leaf_spec(specs, path))
                for path in spec.paths])
        dtypes = {g.dtype for g in grads}
        gdt = dtypes.pop() if len(dtypes) == 1 else torch.float32
        g_flat = F.flatten(grads, gdt, pad_to=FLAT_TILE, align=spec.align)
        del grads
        group = M.data_parallel_group()
        dp = M.group_size(group)
        loss = loss.detach()
        if group is not None:
            M.all_reduce(g_flat, "sum", group)
            loss = M.all_reduce(loss.clone(), "sum", group)
            if dp > 1:
                g_flat.div_(dp)
                loss = loss / dp
        _, new_state = optimizer.step_flat(opt_state, g_flat)
        return new_state, loss

    # the observatory's labels (monitor.analyze_step / comms_report), as
    # parallel.ddp's step carries them
    step.arg_names = ("opt_state", "tokens", "labels")
    step.donate_argnums = (0,)
    step.mesh_axis_names, step.mesh_axis_sizes = M.mesh_axes()
    return step


def _sum_over_pp(grads, replicated):
    """The gradients of the pp-replicated leaves (`replicated[i]`) summed
    over the pp group in place of their partial sums: one all-reduce of
    them flattened together (in their common dtype)."""
    group = M.group_of(M.PP_AXIS)
    idx = [i for i, r in enumerate(replicated) if r]
    if group is None or not idx:
        return
    parts = [grads[i] for i in idx]
    dt = parts[0].dtype if len({g.dtype for g in parts}) == 1 \
        else torch.float32
    flat = torch.cat([g.reshape(-1).to(dt) for g in parts])
    M.all_reduce(flat, "sum", group)
    for i, piece in zip(idx, flat.split([g.numel() for g in parts])):
        grads[i] = piece.view_as(grads[i]).to(grads[i].dtype)
