"""apex_tpu_torch.ops — kernels for Hopper, each beside its plain
PyTorch version (the CPU path and the on-card reference).

Mirrors `apex_tpu.ops`; only the modules of the ported slices exist so
far (layer_norm, flash_decode, flash_attention, softmax,
optimizer_kernels, fused_dense, mlp, xentropy, welford, pooling).
"""

_LAZY = {
    "layer_norm": "apex_tpu_torch.ops.layer_norm",
    "flash_decode": "apex_tpu_torch.ops.flash_decode",
    "flash_attention": "apex_tpu_torch.ops.flash_attention",
    "softmax": "apex_tpu_torch.ops.softmax",
    "optimizer_kernels": "apex_tpu_torch.ops.optimizer_kernels",
    "fused_dense": "apex_tpu_torch.ops.fused_dense",
    "mlp": "apex_tpu_torch.ops.mlp",
    "xentropy": "apex_tpu_torch.ops.xentropy",
    "welford": "apex_tpu_torch.ops.welford",
    "pooling": "apex_tpu_torch.ops.pooling",
}

_SYMBOLS = {
    "fused_layer_norm": ("apex_tpu_torch.ops.layer_norm",
                         "fused_layer_norm"),
    "fused_rms_norm": ("apex_tpu_torch.ops.layer_norm", "fused_rms_norm"),
    "FusedLayerNorm": ("apex_tpu_torch.ops.layer_norm", "FusedLayerNorm"),
    "FusedRMSNorm": ("apex_tpu_torch.ops.layer_norm", "FusedRMSNorm"),
}


def __getattr__(name):
    import importlib
    if name in _LAZY:
        return importlib.import_module(_LAZY[name])
    if name in _SYMBOLS:
        mod, sym = _SYMBOLS[name]
        return getattr(importlib.import_module(mod), sym)
    raise AttributeError(name)
