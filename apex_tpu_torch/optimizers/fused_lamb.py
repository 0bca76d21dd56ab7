"""FusedLAMB — two-phase LAMB over a flat buffer (counterpart of
apex_tpu/optimizers/fused_lamb.py).

A step is the JAX package's: the global grad norm and its clip ratio,
phase 1 (the Adam-style raw update u, with per-tensor weight decay when
`wd_mask` or `lr_scales` is given), the per-tensor norms of p and u, the
trust ratios, and phase 2 (p -= lr · ratio · u).  Every scalar of it —
the clip ratio, the trust ratios, `lr_eff`, the step count — stays on
the device: a step makes no host sync.  `found_inf` skips the step and
leaves params, moments and the step count unchanged.

The flat buffers are laid out by a lane-aligned spec (`align=128`):
every tensor owns whole rows of 128, which the segmented kernels rely
on.  p, m and v are updated IN PLACE (the port's answer to JAX's
donation); u is a fresh buffer in the master dtype each step.

`use_nvlamb` and `adam_w_mode` are accepted as in the JAX package, which
reads neither: the trust ratio applies to every tensor (NVLAMB's rule)
and the weight decay is always decoupled.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import flat as F


class FusedLAMBState(NamedTuple):
    step: torch.Tensor        # int32 scalar on the buffers' device
    params: torch.Tensor      # flat (master) param buffer
    exp_avg: torch.Tensor     # flat m
    exp_avg_sq: torch.Tensor  # flat v


class FusedLAMB(F.FlatCheckpointMixin):
    """opt = FusedLAMB(lr=...); state = opt.init(params);
    params, state = opt.step(state, grads[, lr=, inv_scale=, found_inf=]).

    master_dtype=bf16 keeps p, m, v and u in bf16 (all kernel math in
    fp32), halving the LAMB passes' bytes.  wd_mask / lr_scales: optional
    per-leaf trees of the params' structure; wd_mask leaves multiply
    `weight_decay` per tensor (pass
    `get_params_for_weight_decay_optimization(params)` for the BERT
    no-decay recipe), lr_scales leaves multiply the trust ratio."""

    _STATE = FusedLAMBState

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, amsgrad=False,
                 adam_w_mode=True, grad_averaging=True, max_grad_norm=1.0,
                 use_nvlamb=False, master_dtype=torch.float32,
                 wd_mask=None, lr_scales=None):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.master_dtype = master_dtype
        self.wd_mask = wd_mask
        self.lr_scales = lr_scales
        self._seg_wd: Optional[torch.Tensor] = None
        self._seg_lrs: Optional[torch.Tensor] = None
        self.spec: Optional[F.FlatSpec] = None
        self.device: Optional[torch.device] = None

    def init(self, params) -> FusedLAMBState:
        """Flat state for `params` (a nested dict of tensors), on the
        params' device: a lane-aligned copy of the params in
        `master_dtype` and two distinct zero moment buffers.  The
        per-tensor tables the kernels read are built here, once."""
        self.spec = F.make_spec(params, align=K._LANES)
        flat = F.flatten(params, self.master_dtype, pad_to=K.FLAT_TILE,
                         align=K._LANES)
        dev = self.device = flat.device
        if self.wd_mask is not None or self.lr_scales is not None:
            seg_wd, seg_lrs = F.resolve_per_leaf(
                self.wd_mask, self.lr_scales, self.weight_decay, params,
                type(self).__name__)
            self._seg_wd = torch.from_numpy(seg_wd).to(dev)
            self._seg_lrs = torch.from_numpy(seg_lrs).to(dev)
        K.segment_tables(self.spec, flat.numel() // K._LANES, dev)
        return FusedLAMBState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=flat, exp_avg=torch.zeros_like(flat),
            exp_avg_sq=torch.zeros_like(flat))

    def step(self, state: FusedLAMBState, grads, lr=None, inv_scale=1.0,
             found_inf=False):
        """One step from a grad tree, flattened in its own dtype (one
        float dtype, else fp32): the kernels upcast per element and
        inv_scale folds into phase 1's scalars.  Returns (params_tree,
        new_state)."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step()")
        gdts = {g.dtype for g in F.tree_leaves(grads)}
        gdt = gdts.pop() if len(gdts) == 1 else torch.float32
        g_flat = F.flatten(grads, gdt, pad_to=K.FLAT_TILE,
                           align=self.spec.align)
        return self.step_flat(state, g_flat, lr=lr, inv_scale=inv_scale,
                              found_inf=found_inf)

    def step_flat(self, state: FusedLAMBState, g_flat, lr=None,
                  inv_scale=1.0, found_inf=False):
        """One step from a flat grad buffer (any float dtype, the length
        of `state.params`, laid out by `self.spec`).  `lr`, `inv_scale`
        and `found_inf` may be device tensors."""
        spec = self.spec
        if spec is None:
            raise RuntimeError("call init(params) before step_flat()")
        if g_flat.shape != state.params.shape:
            raise ValueError(f"flat grads {tuple(g_flat.shape)} must match "
                             f"the params buffer {tuple(state.params.shape)}")
        dev = state.params.device
        found = K.device_scalar(found_inf, torch.bool, dev)
        step_next = state.step + (~found).to(torch.int32)
        lr_val = self.lr if lr is None else lr

        # the global grad norm and the clip ratio (clip when the norm
        # exceeds max_grad_norm); the norm is homogeneous, so unscaling
        # multiplies it
        gnorm = K.l2norm_flat(g_flat) * K.device_scalar(
            inv_scale, torch.float32, dev)
        if self.max_grad_norm and self.max_grad_norm > 0:
            clip = torch.where(gnorm > self.max_grad_norm,
                               self.max_grad_norm / gnorm, 1.0)
        else:
            clip = 1.0
        kw = dict(clip_ratio=clip, step=step_next, beta1=self.beta1,
                  beta2=self.beta2, eps=self.eps,
                  bias_correction=self.bias_correction,
                  grad_averaging=self.grad_averaging, inv_scale=inv_scale,
                  found_inf=found)
        if self._seg_wd is not None:
            m, v, u = K.lamb_phase1_seg(
                state.exp_avg, state.exp_avg_sq, g_flat, state.params,
                wd_values=self._seg_wd, spec=spec, **kw)
        else:
            m, v, u = K.lamb_phase1_flat(
                state.exp_avg, state.exp_avg_sq, g_flat, state.params,
                weight_decay=self.weight_decay, **kw)

        # trust ratio per tensor: ‖p‖ / ‖u‖ where both are > 0, else 1
        wn = K.per_tensor_l2norm_aligned(state.params, spec)
        un = K.per_tensor_l2norm_aligned(u, spec)
        ratio = torch.where((wn > 0) & (un > 0),
                            wn / torch.clamp_min(un, 1e-12), 1.0)
        if self._seg_lrs is not None:
            ratio = ratio * self._seg_lrs
        lr_eff = torch.where(found, 0.0,
                             K.device_scalar(lr_val, torch.float32, dev))
        p = K.lamb_phase2_seg(state.params, u, ratio, spec, lr_eff)
        new_state = FusedLAMBState(step=step_next, params=p, exp_avg=m,
                                   exp_avg_sq=v)
        return F.unflatten(p, spec), new_state


class FusedMixedPrecisionLamb(FusedLAMB):
    """≡ the JAX package's FusedMixedPrecisionLamb: the same algorithm;
    the flat buffer in `master_dtype` already is the master copy of
    low-precision model params."""
