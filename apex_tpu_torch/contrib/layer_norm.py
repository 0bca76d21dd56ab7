"""≡ apex.contrib.layer_norm.FastLayerNorm (counterpart of
apex_tpu/contrib/layer_norm.py): a re-export of the port's LayerNorm,
whose kernels take every hidden size."""

from apex_tpu_torch.ops.layer_norm import FusedLayerNorm as FastLayerNorm  # noqa: F401
from apex_tpu_torch.ops.layer_norm import fused_layer_norm  # noqa: F401
