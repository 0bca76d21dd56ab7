"""apex_tpu_torch.fused_dense — fused linear (+bias) (+GELU) (counterpart
of apex_tpu/fused_dense.py, ≡ apex.fused_dense): the ops layer's names
under the reference's."""

from apex_tpu_torch.ops.fused_dense import (  # noqa: F401
    FusedDense,
    FusedDenseGeluDense,
    linear_bias,
    linear_gelu_linear,
    wgrad_accum,
)

__all__ = ["FusedDense", "FusedDenseGeluDense", "linear_bias",
           "linear_gelu_linear", "wgrad_accum"]
