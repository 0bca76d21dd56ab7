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

Across ranks the groups are `parallel.mesh`'s (tp innermost, as the
JAX mesh is laid out).  Each rank's optimizer state holds its tp shard
of the parameters (`init_sharded_optimizer` cuts it by the model's
`partition_specs()`), so rank r's flat buffer is the JAX package's
state rows [r·L, (r+1)·L) of its `P(("pp", "tp"))` buffer.  The model's
tp collectives run inside autograd; the flat gradient is averaged over
the dp group (one all-reduce), and so is the returned loss.  Without a
mesh and without torch.distributed this is the single-device step.
Pipeline parallelism comes with ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.optimizer_kernels import FLAT_TILE
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.transformer.tensor_parallel.layers import shard_tree


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


def init_sharded_optimizer(optimizer, model, params):
    """Optimizer state over this rank's shards of the global `params`
    (the JAX package's: it takes the global tree and `shard_map` hands
    each rank its shard), cut by `model.partition_specs()` over the tp
    group; without one, over all of them.  The state holds its own copy
    of the parameters."""
    group = M.group_of(M.TP_AXIS)
    size = M.group_size(group)
    if size > 1:
        params = shard_tree(params, model.partition_specs(),
                            M.group_rank(group), size)
    return optimizer.init(params)


def make_tp_dp_train_step(model, optimizer, *,
                          loss_fn: Optional[Callable] = None, device=None):
    """Returns step(opt_state, tokens, labels) -> (opt_state, loss).

    `loss_fn(params, tokens, labels)` defaults to `model.loss`; `labels`
    may be a tensor or a tuple or list of tensors (BERT passes
    (mlm_labels, loss_mask, nsp_labels)), moved to the device as it is.
    `tokens` and `labels` are this rank's share of the batch (the dp
    group splits it; the tp ranks of a dp rank see the same).  The step
    takes per-leaf gradients of the local loss, averages them over the
    dp group of `parallel.mesh` (the world without a mesh; none without
    torch.distributed), and makes one fused optimizer pass over the
    rank's shard.  It runs on `device`: the card unless the caller asks
    for the CPU (`device="cpu"`, the plain versions of the kernels)."""
    dev = resolve_device(device)
    lf = loss_fn or model.loss

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
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        dtypes = {g.dtype for g in grads}
        gdt = dtypes.pop() if len(dtypes) == 1 else torch.float32
        g_flat = F.flatten(list(grads), gdt, pad_to=FLAT_TILE,
                           align=spec.align)
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

    return step
