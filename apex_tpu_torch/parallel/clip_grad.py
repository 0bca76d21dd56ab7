"""Gradient clipping by the global norm (counterpart of
apex_tpu/parallel/clip_grad.py, itself ≡
apex.contrib.clip_grad.clip_grad_norm_): the total norm of a grad tree
and the grads scaled by max_norm / (total + 1e-6) when, and only when,
the total exceeds max_norm (torch's rule).  The 2-norm is one fp32
reduction over the flat grads (`l2norm_flat`); the inf-norm and other
p-norms reduce leaf by leaf.  Plain PyTorch, as the JAX package leaves
it to XLA; the total stays a device tensor, so there is no host sync.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import flat as F


def clip_grad_norm(grads, max_norm: float, norm_type: float = 2.0):
    """Returns (clipped_grads, total_norm): the grads' structure (a nested
    dict, or a list of tensors), each leaf in its own dtype, and the fp32
    total norm."""
    is_list = isinstance(grads, (list, tuple))
    leaves = list(grads) if is_list else F.tree_leaves(grads)
    if norm_type == 2.0:
        total = K.l2norm_flat(F.flatten(leaves, torch.float32))
    elif norm_type == float("inf"):
        total = torch.max(torch.stack(
            [torch.max(torch.abs(g.float())) for g in leaves]))
    else:
        total = torch.pow(sum(torch.sum(torch.pow(torch.abs(g.float()),
                                                  norm_type))
                              for g in leaves), 1.0 / norm_type)
    scale = torch.where(total > max_norm, max_norm / (total + 1e-6), 1.0)
    clipped = [(g.float() * scale).to(g.dtype) for g in leaves]
    if is_list:
        return clipped, total
    return F.tree_from_leaves(F.make_spec(grads), clipped), total


clip_grad_norm_ = clip_grad_norm
