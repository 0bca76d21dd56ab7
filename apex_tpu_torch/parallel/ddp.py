"""The data-parallel train step, at one device (counterpart of
apex_tpu/parallel/ddp.py `make_train_step`, itself ≡ the hot loop of
apex's examples/imagenet/main_amp.py: DDP forward, amp.scale_loss,
backward with the gradient allreduce, the fused optimizer step).

The step follows the JAX package's step for step: read the params out
of the optimizer's flat buffer; cast them to the param dtype and then,
with the batch's floating leaves, to the compute dtype, outside the
gradient; take the scaled loss; differentiate with respect to the
compute-dtype leaves (bf16 grads under O1); sync the grads (the
identity on one device); check them for overflow; update the loss
scaler; and hand the grads, `inv_scale` and `found_inf` to the fused
optimizer, which applies the unscale and the overflow skip inside its
kernel.  The grads are flattened once into the optimizer's flat buffer
layout, and the overflow check reads that buffer once (its zero padding
changes nothing).  No `.item()` and no `torch.cuda.synchronize()`
inside the step: the loss comes back as a device tensor.

Gradient accumulation (`num_microbatches`), an fp32 main-grad buffer
(`main_grad_dtype`), the metrics and trace planes, and more than one
rank come with later ROADMAP items and raise until then.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch import amp as amp_lib
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.optimizer_kernels import FLAT_TILE
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.transformer.training import _to_device


def sync_gradients(grads):
    """The dp-mean of the grads: the identity on one device (≡ the JAX
    package's `sync_gradients` over a mesh axis of size 1)."""
    return grads


def make_train_step(loss_fn: Callable, optimizer, *,
                    amp_state: Optional[amp_lib.AmpState] = None,
                    has_aux: bool = False, with_state: bool = False,
                    device=None, num_microbatches: int = 1,
                    main_grad_dtype=None, metrics=None, trace=None):
    """Build the train step (≡ the JAX package's `make_train_step` at one
    device).

    `loss_fn(params, batch) -> loss` (or `(loss, aux)` with has_aux;
    with with_state: `loss_fn(params, model_state, batch) -> (loss,
    new_model_state)`, e.g. the batch norms' running statistics).
    Returns `step(opt_state, scaler_state[, model_state], batch) ->
    (opt_state, scaler_state[, model_state], loss[, aux])`.  The
    optimizer (FusedSGD, FusedAdam, FusedLAMB) updates its flat buffers
    in place.  The step runs on `device`: the card unless the caller
    asks for the CPU (`device="cpu"`, the plain versions of the
    kernels)."""
    if num_microbatches != 1:
        raise NotImplementedError(
            "gradient accumulation (num_microbatches) comes with DDP, "
            "ROADMAP Queue 1 item 12")
    if main_grad_dtype is not None:
        raise NotImplementedError(
            "the fp32 main-grad buffer (main_grad_dtype) comes with DDP, "
            "ROADMAP Queue 1 item 12")
    if metrics not in (None, False) or trace not in (None, False):
        raise NotImplementedError(
            "the metrics and trace planes come with the monitor port, "
            "ROADMAP Queue 1 item 23")
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "data parallelism across ranks comes with DDP over NCCL, "
            "ROADMAP Queue 1 item 12")
    dev = resolve_device(device)
    policy = amp_state.policy if amp_state is not None else None
    dynamic = amp_state.dynamic if amp_state is not None else False

    def local_step(opt_state, scaler_state, model_state, batch):
        spec = optimizer.spec
        if spec is None:
            raise RuntimeError("build the state with optimizer.init before "
                               "stepping")
        if opt_state.params.device != dev:
            raise ValueError(f"optimizer state lives on "
                             f"{opt_state.params.device}, the step on {dev}")
        batch = _to_device(batch, dev)
        leaves = F.unflatten_leaves(opt_state.params, spec)
        if policy is not None:
            leaves = policy.cast_to_param(leaves)
            if policy.compute_dtype != torch.float32:
                # O1/O2: params and the floating batch run in the compute
                # dtype; batch norm and the loss return to fp32 inside
                leaves = policy.cast_to_compute(leaves)
                batch = policy.cast_to_compute(batch)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        params = F.tree_from_leaves(spec, leaves)
        if with_state:
            loss, aux = loss_fn(params, model_state, batch)
        else:
            out = loss_fn(params, batch)
            loss, aux = (out[0], out[1]) if has_aux else (out, None)
        scaled = loss * scaler_state.scale if scaler_state is not None \
            else loss
        # a leaf the loss does not read gets a zero gradient, as under
        # jax.grad
        grads = torch.autograd.grad(scaled, leaves, allow_unused=True,
                                    materialize_grads=True)
        del leaves, params, scaled
        dtypes = {g.dtype for g in grads}
        gdt = dtypes.pop() if len(dtypes) == 1 else torch.float32
        g_flat = sync_gradients(F.flatten(list(grads), gdt, pad_to=FLAT_TILE,
                                          align=spec.align))
        del grads
        if scaler_state is not None:
            inv = 1.0 / scaler_state.scale
            found_inf = amp_lib.scaler.check_finite(g_flat)
            new_scaler = amp_lib.scaler.update(scaler_state, found_inf,
                                               dynamic=dynamic)
        else:
            inv, found_inf, new_scaler = 1.0, False, None
        _, new_opt_state = optimizer.step_flat(opt_state, g_flat,
                                               inv_scale=inv,
                                               found_inf=found_inf)
        outs = (new_opt_state, new_scaler)
        if with_state:
            outs += (_detach(aux),)
        outs += (loss.detach(),)
        if has_aux and not with_state:
            outs += (_detach(aux),)
        return outs

    if with_state:
        def step(opt_state, scaler_state, model_state, batch):
            return local_step(opt_state, scaler_state, model_state, batch)
    else:
        def step(opt_state, scaler_state, batch):
            return local_step(opt_state, scaler_state, None, batch)
    return step


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detach(t) for t in tree)
    return tree
