"""apex_tpu_torch.normalization — fused LayerNorm / RMSNorm (counterpart
of apex_tpu/normalization.py, ≡ apex.normalization): the ops layer's
names under the reference's.  Megatron's "mixed dtype" variants are the
same kernels (statistics are always fp32), so they are aliases."""

from apex_tpu_torch.ops.layer_norm import (  # noqa: F401
    FusedLayerNorm,
    FusedRMSNorm,
    fused_layer_norm,
    fused_rms_norm,
    layer_norm_reference,
    rms_norm_reference,
)

MixedFusedLayerNorm = FusedLayerNorm
MixedFusedRMSNorm = FusedRMSNorm

__all__ = [
    "FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
    "MixedFusedRMSNorm", "fused_layer_norm", "fused_rms_norm",
    "layer_norm_reference", "rms_norm_reference",
]
