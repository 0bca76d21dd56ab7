"""FusedAdagrad — one kernel pass of Adagrad over a flat buffer
(counterpart of apex_tpu/optimizers/fused_adagrad.py, itself ≡
apex.optimizers.FusedAdagrad over amp_C.multi_tensor_adagrad).

All parameters live in one fp32 flat buffer (`flat.flatten`, padded to
`FLAT_TILE`) beside an fp32 sum of squared grads, as in the JAX
package, and one launch of the Adagrad kernel updates both IN PLACE:
the state `step` returns holds the same tensors, updated.  Weight decay
is L2 (added to the gradient) or, with `adagrad_w_mode`, decoupled
(added to the update).  `lr` may be a device tensor, so a step makes no
host sync.  Like the JAX package's, the optimizer takes no loss scale
and no overflow flag: it is driven by `make_tp_dp_train_step`, whose
`step_flat` call passes neither.  It keeps no checkpoint record of its
layout (the JAX package's FusedAdagrad has none either).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import flat as F


class FusedAdagradState(NamedTuple):
    step: torch.Tensor     # int32 scalar on the buffers' device
    params: torch.Tensor   # flat fp32 param buffer
    sum_sq: torch.Tensor   # flat fp32 sum of squared grads


class FusedAdagrad:
    """opt = FusedAdagrad(lr=...); state = opt.init(params);
    params, state = opt.step(state, grads[, lr=])."""

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 adagrad_w_mode=False):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.adagrad_w_mode = adagrad_w_mode
        self.spec: Optional[F.FlatSpec] = None

    def init(self, params) -> FusedAdagradState:
        """Flat state for `params` (a nested dict of tensors), on the
        params' device: an fp32 copy of the params and a zero sum of
        squares."""
        self.spec = F.make_spec(params)
        flat = F.flatten(params, torch.float32, pad_to=K.FLAT_TILE)
        return FusedAdagradState(
            step=torch.zeros((), dtype=torch.int32, device=flat.device),
            params=flat, sum_sq=torch.zeros_like(flat))

    def step(self, state: FusedAdagradState, grads, lr=None):
        """One fused step from a grad tree (flattened in its own float
        dtype).  Returns (params_tree, new_state)."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step()")
        gdts = {g.dtype for g in F.tree_leaves(grads)}
        gdt = gdts.pop() if len(gdts) == 1 else torch.float32
        return self.step_flat(state, F.flatten(grads, gdt,
                                               pad_to=K.FLAT_TILE), lr=lr)

    def step_flat(self, state: FusedAdagradState, g_flat, lr=None):
        """One fused step from a flat grad buffer (any float dtype, the
        length of `state.params`)."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step_flat()")
        if g_flat.shape != state.params.shape:
            raise ValueError(f"flat grads {tuple(g_flat.shape)} must match "
                             f"the params buffer {tuple(state.params.shape)}")
        p, h = K.adagrad_flat(
            state.params, state.sum_sq, g_flat,
            self.lr if lr is None else lr, eps=self.eps,
            weight_decay=self.weight_decay,
            adagrad_w_mode=self.adagrad_w_mode)
        new_state = FusedAdagradState(step=state.step + 1, params=p,
                                      sum_sq=h)
        return F.unflatten(p, self.spec), new_state
