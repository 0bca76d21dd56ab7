"""FusedNovoGrad — NovoGrad over a flat buffer (counterpart of
apex_tpu/optimizers/fused_novograd.py, itself ≡
apex.optimizers.FusedNovoGrad over amp_C.multi_tensor_novograd).

The second moment is one scalar per tensor: an EMA of the squared norm
of the tensor's gradient, started at the first step's squared norm
(or from zero with `init_zero`).  The per-tensor norms come from the
per-tensor sums-of-squares kernel over the lane-aligned flat gradient
(`per_tensor_l2norm_aligned`: one launch of `rows_sumsq_seg` a step);
the elementwise moment and parameter update is plain PyTorch over the
fp32 flat buffers, as the JAX package leaves it to XLA.  Weight decay
is added to the normalised gradient (`reg_inside_moment`) or to the
update; `grad_averaging` scales the new gradient by 1 - beta1; bias
correction divides the update by 1 - beta1^step.

params, m and the per-tensor v are updated IN PLACE.  `lr`,
`inv_scale` and `found_inf` may be device tensors: an overflow keeps
params, m, v and the step count, with no host sync.  Checkpoints carry
the layout fingerprint (`flat.FlatCheckpointMixin`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import flat as F


class FusedNovoGradState(NamedTuple):
    step: torch.Tensor        # int32 scalar on the buffers' device
    params: torch.Tensor      # flat fp32 param buffer (lane-aligned)
    exp_avg: torch.Tensor     # flat m
    exp_avg_sq: torch.Tensor  # (n_tensors,) per-tensor v


class FusedNovoGrad(F.FlatCheckpointMixin):
    """opt = FusedNovoGrad(lr=...); state = opt.init(params);
    params, state = opt.step(state, grads[, lr=, inv_scale=, found_inf=]).
    """

    _STATE = FusedNovoGradState

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.95, 0.98),
                 eps=1e-8, weight_decay=0.0, grad_averaging=False,
                 amsgrad=False, reg_inside_moment=False, norm_type=2,
                 init_zero=False):
        if amsgrad:
            raise RuntimeError(
                "FusedNovoGrad does not support the AMSGrad variant.")
        if norm_type != 2:
            raise ValueError("FusedNovoGrad only supports l2 norm now")
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_averaging = grad_averaging
        self.reg_inside_moment = reg_inside_moment
        self.init_zero = init_zero
        self.spec: Optional[F.FlatSpec] = None
        self.device: Optional[torch.device] = None

    def init(self, params) -> FusedNovoGradState:
        """Flat state for `params` (a nested dict of tensors), on the
        params' device: a lane-aligned fp32 copy of the params, a zero m
        and a zero v per tensor.  The per-tensor tables the norm kernel
        reads are built here, once."""
        self.spec = F.make_spec(params, align=K._LANES)
        flat = F.flatten(params, torch.float32, pad_to=K.FLAT_TILE,
                         align=K._LANES)
        dev = self.device = flat.device
        K.segment_tables(self.spec, flat.numel() // K._LANES, dev)
        return FusedNovoGradState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=flat, exp_avg=torch.zeros_like(flat),
            exp_avg_sq=torch.zeros((len(self.spec.sizes),),
                                   dtype=torch.float32, device=dev))

    def step(self, state: FusedNovoGradState, grads, lr=None, inv_scale=1.0,
             found_inf=False):
        """One step from a grad tree (flattened in its own float dtype).
        Returns (params_tree, new_state)."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step()")
        gdts = {g.dtype for g in F.tree_leaves(grads)}
        gdt = gdts.pop() if len(gdts) == 1 else torch.float32
        g_flat = F.flatten(grads, gdt, pad_to=K.FLAT_TILE, align=K._LANES)
        return self.step_flat(state, g_flat, lr=lr, inv_scale=inv_scale,
                              found_inf=found_inf)

    def step_flat(self, state: FusedNovoGradState, g_flat, lr=None,
                  inv_scale=1.0, found_inf=False):
        """One step from a flat grad buffer (any float dtype, the length
        of `state.params`, laid out by `self.spec`)."""
        spec = self.spec
        if spec is None:
            raise RuntimeError("call init(params) before step_flat()")
        if g_flat.shape != state.params.shape:
            raise ValueError(f"flat grads {tuple(g_flat.shape)} must match "
                             f"the params buffer {tuple(state.params.shape)}")
        dev = state.params.device
        f32 = torch.float32
        g = g_flat.float() * K.device_scalar(inv_scale, f32, dev)
        found = K.device_scalar(found_inf, torch.bool, dev)
        step_next = state.step + (~found).to(torch.int32)
        lr_val = self.lr if lr is None else lr

        # the per-tensor EMA of the squared grad norm, started at the
        # first step's squared norm unless init_zero
        gn2 = torch.square(K.per_tensor_l2norm_aligned(g, spec))
        v_cont = self.beta2 * state.exp_avg_sq + (1.0 - self.beta2) * gn2
        v_new = v_cont if self.init_zero else torch.where(
            state.step == 0, gn2, v_cont)
        denom = K.expand_per_tensor_aligned(torch.sqrt(v_new) + self.eps,
                                            spec, g.numel())

        p32 = state.params
        gg = g / denom
        del g, denom
        if self.weight_decay and self.reg_inside_moment:
            gg = gg + self.weight_decay * p32
        beta1_scale = (1.0 - self.beta1) if self.grad_averaging else 1.0
        m_new = self.beta1 * state.exp_avg + beta1_scale * gg
        del gg
        upd = m_new
        if self.weight_decay and not self.reg_inside_moment:
            upd = upd + self.weight_decay * p32
        if self.bias_correction:
            bc1 = 1.0 - torch.pow(K.device_scalar(self.beta1, f32, dev),
                                  step_next.to(f32))
            upd = upd / bc1
        p_new = p32 - lr_val * upd
        del upd
        state.params.copy_(torch.where(found, p32, p_new))
        state.exp_avg.copy_(torch.where(found, state.exp_avg, m_new))
        state.exp_avg_sq.copy_(torch.where(found, state.exp_avg_sq, v_new))
        new_state = FusedNovoGradState(
            step=step_next, params=state.params, exp_avg=state.exp_avg,
            exp_avg_sq=state.exp_avg_sq)
        return F.unflatten(state.params, spec), new_state
