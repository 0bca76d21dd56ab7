"""Attention-softmax dispatcher (counterpart of
apex_tpu/transformer/functional/fused_softmax.py, itself ≡ apex's
FusedScaleMaskSoftmax).

Picks the softmax variant by attention-mask type: causal, masked or
plain, all three the `ops/softmax.py` kernels on the card (their plain
versions on the CPU).  The kernels take every sequence length and batch
shape, so only the fusion flag gates them, as in the JAX package.
"""

from __future__ import annotations

import enum
from typing import Optional

from apex_tpu_torch.ops import softmax as S


class AttnMaskType(enum.Enum):
    """≡ the JAX package's AttnMaskType (apex/transformer/enums.py)."""
    padding = 1
    causal = 2
    no_mask = 3


class FusedScaleMaskSoftmax:
    """≡ the JAX package's FusedScaleMaskSoftmax."""

    def __init__(self, attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func=None, softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        self.attn_mask_type = attn_mask_type
        self.fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if self.scale is not None and not softmax_in_fp32:
            raise RuntimeError(
                "softmax should be in fp32 when scaled")

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """The kernels cover every shape; only the fusion flag gates
        them."""
        return self.fusion

    def __call__(self, inputs, mask=None):
        scale = self.scale if self.scale is not None else 1.0
        if self.attn_mask_type == AttnMaskType.causal:
            b, np_, sq, sk = inputs.shape
            x = inputs.reshape(-1, sq, sk)
            out = S.scaled_upper_triang_masked_softmax(x, scale)
            return out.reshape(inputs.shape)
        if mask is not None:
            return S.scaled_masked_softmax(inputs, mask, scale)
        return S.scaled_softmax(inputs, scale)
