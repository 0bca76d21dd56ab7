"""Attention-softmax dispatch (counterpart of
apex_tpu.transformer.functional)."""

from apex_tpu_torch.transformer.functional.fused_softmax import (  # noqa: F401
    AttnMaskType,
    FusedScaleMaskSoftmax,
)
