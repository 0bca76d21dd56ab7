"""apex_tpu_torch.contrib — optional fused components (counterpart of
apex_tpu.contrib): compositions over the port's kernels (flash
attention, the LayerNorm kernels, the channel sums, the collectives)
and PyTorch's own operators.  The JAX package's list also names
`cudnn_gbn`, which has no module there; its class is
`groupbn.GroupBatchNorm2d`, so no such name is mapped here."""

_MODULES = ("multihead_attn", "focal_loss", "index_mul_2d", "transducer",
            "sparsity", "groupbn", "peer_memory", "bottleneck", "xentropy",
            "clip_grad", "conv_bias_relu", "fmha", "layer_norm",
            "optimizers")


def __getattr__(name):
    import importlib

    if name in _MODULES:
        return importlib.import_module(f"apex_tpu_torch.contrib.{name}")
    raise AttributeError(name)
