"""Fused dense helpers (counterpart of apex_tpu/ops/fused_dense.py; only
the packed-QKV head split of the GPT block is ported so far — the tiled
GEMM kernel `_matmul_kernel` and its callers are ROADMAP Queue 1 item
20)."""

from __future__ import annotations


def qkv_split_heads(qkv, num_heads, head_dim):
    """Packed-QKV head split: (S, B, 3·nh·d) → three (B, nh, S, d) views.

    The packed tensor is transposed once to (3, B, nh, S, d) and q, k, v
    are its leading-dim slices (`unbind`, whose gradient is one stack),
    as in the JAX package.  The views are not contiguous: the flash
    kernels read them through their strides."""
    s, b = qkv.shape[:2]
    qkv = qkv.reshape(s, b, 3, num_heads, head_dim)
    return qkv.permute(2, 1, 3, 0, 4).unbind(0)
