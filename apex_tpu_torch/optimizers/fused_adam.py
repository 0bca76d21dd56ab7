"""FusedAdam — one kernel pass of Adam/AdamW over a flat buffer
(counterpart of apex_tpu/optimizers/fused_adam.py).

All parameters live in one flat buffer (`flat.flatten`, padded to
`FLAT_TILE`), and one launch of the Adam kernel updates params and both
moments.  The update is IN PLACE on the flat buffers: the state that
`step` returns holds the same tensors, updated, which is the port's
answer to JAX's buffer donation (no second copy of the state is ever
alive).  `lr`, `step`, `inv_scale` and `found_inf` may be device
tensors: the overflow skip is folded into the kernel's scalars, so
there is no host sync.

`master_dtype` is the flat buffers' dtype: fp32 (the master copy), or
bf16 for params and moments at 6 bytes per parameter.

Per-leaf weight decay and lr scales (`wd_mask`, `lr_scales`) are
apex's param groups in one pass: with either one, the flat buffers are
laid out by a lane-aligned spec (every tensor owns whole rows of 128),
the per-tensor values are resolved once at `init`, and each step is one
launch of the segmented kernel `adam_flat_seg`.  Without them a step is
one launch of the uniform kernel `adam_flat`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import flat as F


class FusedAdamState(NamedTuple):
    step: torch.Tensor        # int32 scalar on the buffers' device
    params: torch.Tensor      # flat (master) param buffer
    exp_avg: torch.Tensor     # flat m
    exp_avg_sq: torch.Tensor  # flat v


class FusedAdam(F.FlatCheckpointMixin):
    """opt = FusedAdam(lr=...); state = opt.init(params);
    params, state = opt.step(state, grads[, lr=, inv_scale=, found_inf=]).

    wd_mask / lr_scales: optional per-leaf trees of the params'
    structure; wd_mask leaves (bool or float) multiply `weight_decay` per
    tensor (pass `get_params_for_weight_decay_optimization(params)` for
    the no-decay-for-bias/norm groups), lr_scales leaves multiply `lr`
    per tensor."""

    _STATE = FusedAdamState

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0,
                 amsgrad=False, master_dtype=torch.float32, wd_mask=None,
                 lr_scales=None):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.master_dtype = master_dtype
        self.wd_mask = wd_mask
        self.lr_scales = lr_scales
        self._seg_wd: Optional[torch.Tensor] = None
        self._seg_lrs: Optional[torch.Tensor] = None
        self.spec: Optional[F.FlatSpec] = None
        self.device: Optional[torch.device] = None

    @property
    def _per_leaf(self) -> bool:
        return self.wd_mask is not None or self.lr_scales is not None

    def init(self, params) -> FusedAdamState:
        """Flat state for `params` (a nested dict of tensors), on the
        params' device: a fresh copy of the params in `master_dtype` and
        two distinct zero moment buffers.  With per-leaf values the
        layout is lane-aligned and the per-tensor tables the kernel
        reads are built here, once."""
        align = K._LANES if self._per_leaf else 1
        self.spec = F.make_spec(params, align=align)
        flat = F.flatten(params, self.master_dtype, pad_to=K.FLAT_TILE,
                         align=align)
        dev = self.device = flat.device
        if self._per_leaf:
            seg_wd, seg_lrs = F.resolve_per_leaf(
                self.wd_mask, self.lr_scales, self.weight_decay, params,
                type(self).__name__)
            self._seg_wd = torch.from_numpy(seg_wd).to(dev)
            self._seg_lrs = torch.from_numpy(seg_lrs).to(dev)
            K.segment_tables(self.spec, flat.numel() // K._LANES, dev)
        return FusedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=flat, exp_avg=torch.zeros_like(flat),
            exp_avg_sq=torch.zeros_like(flat))

    def step(self, state: FusedAdamState, grads, lr=None, inv_scale=1.0,
             found_inf=False):
        """One fused step from a grad tree.  Returns (params_tree,
        new_state); the grads are flattened in their own dtype (one
        float dtype) and the kernel upcasts per element."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step()")
        gdts = {g.dtype for g in F.tree_leaves(grads)}
        gdt = gdts.pop() if len(gdts) == 1 else torch.float32
        g_flat = F.flatten(grads, gdt, pad_to=K.FLAT_TILE,
                           align=self.spec.align)
        return self.step_flat(state, g_flat, lr=lr, inv_scale=inv_scale,
                              found_inf=found_inf)

    def step_flat(self, state: FusedAdamState, g_flat, lr=None,
                  inv_scale=1.0, found_inf=False):
        """One fused step from a flat grad buffer (any float dtype, the
        length of `state.params`).  The step count advances only when
        `found_inf` is false; on an overflow p, m and v are kept."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step_flat()")
        if g_flat.shape != state.params.shape:
            raise ValueError(f"flat grads {tuple(g_flat.shape)} must match "
                             f"the params buffer {tuple(state.params.shape)}")
        found = K.device_scalar(found_inf, torch.bool, state.params.device)
        step_next = state.step + (~found).to(torch.int32)
        kw = dict(lr=self.lr if lr is None else lr, step=step_next,
                  beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                  adam_w_mode=self.adam_w_mode,
                  bias_correction=self.bias_correction, inv_scale=inv_scale,
                  found_inf=found)
        if self._per_leaf:
            p, m, v = K.adam_flat_seg(
                state.params, state.exp_avg, state.exp_avg_sq, g_flat,
                wd_values=self._seg_wd, lr_scale_values=self._seg_lrs,
                spec=self.spec, **kw)
        else:
            p, m, v = K.adam_flat(
                state.params, state.exp_avg, state.exp_avg_sq, g_flat,
                weight_decay=self.weight_decay, **kw)
        new_state = FusedAdamState(step=step_next, params=p, exp_avg=m,
                                   exp_avg_sq=v)
        return F.unflatten(p, self.spec), new_state
