"""Sigmoid focal loss for detection (counterpart of
apex_tpu/contrib/focal_loss.py, itself ≡ apex.contrib.focal_loss,
apex/contrib/focal_loss/focal_loss.py:42): anchor classification logits
with label smoothing, in fp32 (fp64 inputs stay fp64).  One elementwise expression and a sum:
PyTorch's own operators (ATen), as the JAX package leaves it to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def focal_loss(cls_output, cls_targets_at_level, num_positives_sum,
               num_real_classes, alpha=0.25, gamma=2.0,
               label_smoothing=0.0):
    """≡ focal_loss_cuda.focal_loss_forward (the JAX package's formula).

    cls_output: (..., num_classes_padded) raw logits; only the first
    `num_real_classes` are read.  cls_targets_at_level: (...) int: -2
    ignore (the entry gives 0), -1 background (all-zero targets), >= 0 a
    class id.  Returns the summed loss over max(num_positives_sum, 1)."""
    x = cls_output[..., :num_real_classes]
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    t = cls_targets_at_level
    onehot = F.one_hot(t.clamp_min(0).long(), num_real_classes).to(x.dtype)
    y = torch.where((t >= 0)[..., None], onehot, 0.0)
    if label_smoothing > 0:
        y = y * (1.0 - label_smoothing) + 0.5 * label_smoothing
    p = torch.sigmoid(x)
    ce = x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))
    p_t = p * y + (1.0 - p) * (1.0 - y)
    mod = torch.pow(1.0 - p_t, gamma)
    alpha_t = alpha * y + (1.0 - alpha) * (1.0 - y)
    loss = torch.where((t != -2)[..., None], alpha_t * mod * ce, 0.0)
    n = torch.as_tensor(num_positives_sum, dtype=x.dtype, device=x.device)
    return loss.sum() / n.clamp_min(1.0)
