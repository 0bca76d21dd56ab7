"""The training step on one device (counterpart of
apex_tpu/transformer/training.py, at a 1x1x1 mesh).

The optimizer state owns the parameters: its flat buffer is the master
copy and the model reads its weights as views into it (`flat.unflatten`
views when the master dtype is the model's, cast copies otherwise).  A
step is the JAX package's shape: per-leaf gradients of the loss, one
concatenate into the padded flat gradient buffer, then one fused
optimizer pass (`step_flat`) that updates the buffers in place.  No
`torch.cuda.synchronize()` and no `.item()` inside the step: the loss
comes back as a device tensor.

Data parallelism (dp-mean of the grads), tensor/pipeline parallelism
and the mesh come with later ROADMAP slices.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.optimizer_kernels import FLAT_TILE
from apex_tpu_torch.optimizers import flat as F


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
    """Optimizer state over the parameters (one device: nothing is
    sharded).  The state holds its own copy of `params`."""
    return optimizer.init(params)


def make_tp_dp_train_step(model, optimizer, *,
                          loss_fn: Optional[Callable] = None, device=None):
    """Returns step(opt_state, tokens, labels) -> (opt_state, loss).

    `loss_fn(params, tokens, labels)` defaults to `model.loss`; `labels`
    may be a tensor or a tuple or list of tensors (BERT passes
    (mlm_labels, loss_mask, nsp_labels)), moved to the device as it is.
    The step runs on `device`: the card unless the caller asks for the
    CPU (`device="cpu"`, the plain versions of the kernels)."""
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
        _, new_state = optimizer.step_flat(opt_state, g_flat)
        return new_state, loss.detach()

    return step
