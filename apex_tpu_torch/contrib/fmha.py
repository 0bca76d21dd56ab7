"""FMHA facade (counterpart of apex_tpu/contrib/fmha.py, itself ≡
apex.contrib.fmha's FMHAFun / FMHA, apex/contrib/fmha/fmha.py:33-72):
packed qkv (B, S, 3, h, d) through `ops.flash_attention.flash_attention`,
with the reference's variable-length packing (`cu_seqlens`) as segment
ids, so packed sequences cost no cross attention.  The reference caps
sequences at 512 tokens of head dim 64; the flash kernels have no cap.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.flash_attention import flash_attention


def segment_ids_from_cu_seqlens(cu_seqlens, seq_len: int):
    """cu_seqlens (n + 1,) cumulative boundaries of n packed sequences →
    (1, seq_len) int32 segment ids (the JAX package's): a position's id is
    1 + the number of boundaries after the first that it has reached, so
    the first sequence is 1 and positions past the last boundary get n +
    1 (a pad segment)."""
    cu = torch.as_tensor(cu_seqlens)
    pos = torch.arange(seq_len, device=cu.device)
    return ((pos[None, :] >= cu[1:, None]).sum(dim=0, dtype=torch.int32)
            + 1)[None, :]


class FMHAFun:
    """≡ fmha.FMHAFun: qkv (B, S, 3, h, d) → (B, S, h, d).  Packing into
    one row takes `cu_seqlens` (batch 1) or `segment_ids` (B, S)."""

    @staticmethod
    def apply(qkv, causal=False, softmax_scale=None, segment_ids=None,
              cu_seqlens=None):
        if cu_seqlens is not None:
            if segment_ids is not None:
                raise ValueError("pass segment_ids or cu_seqlens, not both")
            if qkv.shape[0] != 1:
                raise ValueError("cu_seqlens packing implies batch 1 "
                                 "(one packed row); use segment_ids for "
                                 "batched packing")
            segment_ids = segment_ids_from_cu_seqlens(
                torch.as_tensor(cu_seqlens, device=qkv.device),
                qkv.shape[1])
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        o = flash_attention(q, k, v, causal=causal,
                            softmax_scale=softmax_scale,
                            segment_ids=segment_ids)
        return o.permute(0, 2, 1, 3)


class FMHA:
    """≡ fmha.FMHA (fmha.py:60)."""

    def __init__(self, causal: bool = False):
        self.causal = causal

    def __call__(self, qkv, softmax_scale=None, segment_ids=None,
                 cu_seqlens=None):
        return FMHAFun.apply(qkv, self.causal, softmax_scale, segment_ids,
                             cu_seqlens)
