"""FusedSGD — one kernel pass of SGD with momentum over a flat buffer
(counterpart of apex_tpu/optimizers/fused_sgd.py, itself ≡
apex.optimizers.FusedSGD over amp_C.multi_tensor_sgd).

All parameters live in one flat buffer (`flat.flatten`, padded to
`FLAT_TILE`), and one launch of the SGD kernel updates params and the
momentum buffer IN PLACE: the state `step` returns holds the same
tensors, updated.  The first step's buf := g (torch's buf-is-None
branch) is a device-side select on `state.step == 0` inside the kernel,
and `lr`, `inv_scale` and `found_inf` may be device tensors, so a step
makes no host sync.  On an overflow (`found_inf`) params and buffer are
kept and the step count does not advance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import flat as F


class FusedSGDState(NamedTuple):
    step: torch.Tensor             # int32 scalar on the buffers' device
    params: torch.Tensor           # flat (master) param buffer
    momentum_buffer: torch.Tensor  # flat momentum buffer


class FusedSGD:
    """opt = FusedSGD(lr=..., momentum=...); state = opt.init(params);
    params, state = opt.step(state, grads[, lr=, inv_scale=, found_inf=]).
    """

    def __init__(self, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 master_dtype=torch.float32):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        self.lr = lr
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum
        self.master_dtype = master_dtype
        self.spec: Optional[F.FlatSpec] = None

    def init(self, params) -> FusedSGDState:
        """Flat state for `params` (a nested dict of tensors), on the
        params' device: a copy of the params in `master_dtype` and a zero
        momentum buffer."""
        self.spec = F.make_spec(params)
        flat = F.flatten(params, self.master_dtype, pad_to=K.FLAT_TILE)
        return FusedSGDState(
            step=torch.zeros((), dtype=torch.int32, device=flat.device),
            params=flat, momentum_buffer=torch.zeros_like(flat))

    def step(self, state: FusedSGDState, grads, lr=None, inv_scale=1.0,
             found_inf=False):
        """One fused step from a grad tree (flattened in its own float
        dtype).  Returns (params_tree, new_state)."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step()")
        gdts = {g.dtype for g in F.tree_leaves(grads)}
        gdt = gdts.pop() if len(gdts) == 1 else torch.float32
        g_flat = F.flatten(grads, gdt, pad_to=K.FLAT_TILE)
        return self.step_flat(state, g_flat, lr=lr, inv_scale=inv_scale,
                              found_inf=found_inf)

    def step_flat(self, state: FusedSGDState, g_flat, lr=None,
                  inv_scale=1.0, found_inf=False):
        """One fused step from a flat grad buffer (any float dtype, the
        length of `state.params`)."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step_flat()")
        if g_flat.shape != state.params.shape:
            raise ValueError(f"flat grads {tuple(g_flat.shape)} must match "
                             f"the params buffer {tuple(state.params.shape)}")
        found = K.device_scalar(found_inf, torch.bool, state.params.device)
        momentum = self.momentum
        p, buf = K.sgd_flat(
            state.params, state.momentum_buffer, g_flat,
            lr=self.lr if lr is None else lr, momentum=momentum,
            dampening=self.dampening,
            nesterov=self.nesterov and momentum != 0.0,
            weight_decay=self.weight_decay,
            wd_after_momentum=self.wd_after_momentum, first_run=False,
            first=state.step == 0, inv_scale=inv_scale, found_inf=found)
        step_next = state.step + (~found).to(torch.int32)
        new_state = FusedSGDState(step=step_next, params=p,
                                  momentum_buffer=buf)
        return F.unflatten(p, self.spec), new_state
