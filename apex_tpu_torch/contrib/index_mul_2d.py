"""Gather-multiply, out = in1[idx] * in2 (counterpart of
apex_tpu/contrib/index_mul_2d.py, itself ≡ apex.contrib.index_mul_2d,
apex/contrib/index_mul_2d/index_mul_2d.py:5): the reference's
hand-written backward as a `torch.autograd.Function` over PyTorch's own
gather and `index_add_` (ATen), as the JAX package's custom_vjp leaves
them to XLA."""

from __future__ import annotations

import torch


class _IndexMul2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, in1, in2, idx):
        ctx.save_for_backward(in1, in2, idx)
        return in1.index_select(0, idx) * in2

    @staticmethod
    def backward(ctx, g):
        in1, in2, idx = ctx.saved_tensors
        d_in1 = d_in2 = None
        if ctx.needs_input_grad[0]:
            d_in1 = torch.zeros_like(in1).index_add_(0, idx, in2 * g)
        if ctx.needs_input_grad[1]:
            d_in2 = in1.index_select(0, idx) * g
        return d_in1, d_in2, None


def index_mul_2d(in1, in2, idx):
    """in1 (N, D), in2 (M, D), idx (M,) int → (M, D) = in1[idx] * in2;
    d_in1 is the scatter-add of in2 * g over idx, d_in2 = in1[idx] * g,
    and idx has no gradient."""
    return _IndexMul2d.apply(in1, in2, idx.long())
