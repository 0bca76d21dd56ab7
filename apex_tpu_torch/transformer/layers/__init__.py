"""apex_tpu_torch.transformer.layers (counterpart of
apex_tpu.transformer.layers): the sequence-parallel LayerNorm."""

from apex_tpu_torch.transformer.layers.layer_norm import LayerNorm  # noqa: F401
