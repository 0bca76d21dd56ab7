"""Per-model FLOP accounting for MFU (counterpart of
apex_tpu/monitor/flops.py: the same formulas, so equal configs give
equal integers in both packages).

  * every GEMM counts 2*M*K*N, and fwd+bwd counts 3x fwd (dgrad +
    wgrad are the two transposed matmuls of the backward);
  * attention scores/context count the FULL S x S square even for
    causal models (executed-flop MFU, not a 2x-flattering "causal"
    MFU);
  * LayerNorm/softmax/optimizer FLOPs are omitted (sub-1% and
    bandwidth-bound).

The peak table keeps the JAX package's TPU rows and its fallback (so a
CPU run gives the JAX package's numbers) and adds the NVIDIA cards the
port runs on: `device_peak_flops()` reads `torch.cuda.get_device_name()`
when a card is present.
"""

from __future__ import annotations

from typing import Optional

# v5e bf16 matmul peak: the documented fallback when the device kind is
# unknown (CPU runs, exotic kinds), as in the JAX package
V5E_BF16_PEAK = 197e12

# normalized device generation -> per-chip bf16 dense matmul peak
# (FLOP/s).  TPU rows: the public TPU spec sheets (the JAX package's
# table).  H100 rows: NVIDIA's H100 data sheet, bf16 tensor core,
# dense (without sparsity), at the card's full power limit.
DEVICE_BF16_PEAKS = {
    "v2": 45e12,
    "v3": 123e12,
    "v4": 275e12,
    "v5e": 197e12,
    "v5p": 459e12,
    "v6e": 918e12,
    "h100-sxm": 989.4e12,
    "h100-pcie": 756e12,
}


def _normalize_device_kind(kind: str) -> Optional[str]:
    """Map a device name onto a DEVICE_BF16_PEAKS key: an NVIDIA name
    ("NVIDIA H100 80GB HBM3" is the SXM part, "NVIDIA H100 PCIe" the
    PCIe one) or a TPU `device_kind` ("TPU v4", "TPU v5 lite", ...).
    Order matters: "v5 lite"/"v5e" must win before the bare "v5" of
    v5p-style strings."""
    k = kind.lower()
    if "h100" in k:
        return "h100-pcie" if "pcie" in k else "h100-sxm"
    if "v6" in k or "trillium" in k:
        return "v6e"
    if "v5e" in k or "v5 lite" in k or "v5lite" in k:
        return "v5e"
    if "v5p" in k or "v5" in k:
        return "v5p"
    if "v4" in k:
        return "v4"
    if "v3" in k:
        return "v3"
    if "v2" in k:
        return "v2"
    return None


def device_peak_flops(device_kind: Optional[str] = None, *,
                      override: Optional[float] = None,
                      default: float = V5E_BF16_PEAK) -> float:
    """Per-chip bf16 peak for MFU, resolved from the device kind.

    override wins outright (a card set below its power limit, a peak
    measured rather than quoted).  device_kind=None reads
    `torch.cuda.get_device_name()` when a card is present; an
    unrecognized kind, or no card (a CPU run), falls back to `default`
    = V5E_BF16_PEAK, as the JAX package does."""
    if override is not None:
        return float(override)
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return default
        device_kind = torch.cuda.get_device_name()
    norm = _normalize_device_kind(str(device_kind))
    return DEVICE_BF16_PEAKS.get(norm, default)


def transformer_step_flops(*, hidden: int, num_layers: int,
                           num_heads: int, vocab_size: int, batch: int,
                           seq: int, ffn_mult: int = 4,
                           with_head: bool = True) -> int:
    """Fwd+bwd FLOPs of one training step of a standard pre-LN
    transformer (GPT/BERT body): QKV+out projections, S x S attention,
    ffn_mult MLP, optional tied LM head."""
    b, s, h, l = batch, seq, hidden, num_layers
    d = hidden // num_heads
    proj = 2 * b * s * h * 4 * h            # qkv (3h) + out (h) GEMMs
    sdpa = 2 * b * num_heads * s * s * d * 2  # scores + context
    attn = (proj + sdpa) * 3
    mlp = 2 * b * s * h * (2 * ffn_mult * h) * 3   # up + down GEMMs
    total = (attn + mlp) * l
    if with_head:
        total += 2 * b * s * h * vocab_size * 3
    return int(total)


def gpt_step_flops(config, batch: int, seq=None) -> int:
    """Step FLOPs for a `models.gpt.GPTConfig` (seq defaults to the
    config's seq_len)."""
    return transformer_step_flops(
        hidden=config.hidden, num_layers=config.num_layers,
        num_heads=config.num_heads, vocab_size=config.vocab_size,
        batch=batch, seq=config.seq_len if seq is None else seq,
        ffn_mult=config.ffn_mult, with_head=True)


def bert_step_flops(config, batch: int, seq=None) -> int:
    """Step FLOPs for a `models.bert.BertConfig` (MLM head = the same
    tied vocab GEMM; the NSP head is negligible)."""
    return transformer_step_flops(
        hidden=config.hidden, num_layers=config.num_layers,
        num_heads=config.num_heads, vocab_size=config.vocab_size,
        batch=batch, seq=config.seq_len if seq is None else seq,
        ffn_mult=getattr(config, "ffn_mult", 4), with_head=True)


def mfu(flops_per_step: float, step_time_s: float,
        peak_flops: Optional[float] = None) -> float:
    """Model FLOP utilization in [0, inf): achieved model FLOP/s over
    the hardware peak.  >1 means the accounting under-counts (or the
    peak is wrong for the device).

    peak_flops=None resolves the per-chip peak from the device
    (`device_peak_flops`).  Multi-chip MFU wants the AGGREGATE peak:
    pass `device_peak_flops() * n_chips` explicitly."""
    if peak_flops is None:
        peak_flops = device_peak_flops()
    if step_time_s <= 0 or peak_flops <= 0:
        return 0.0
    return flops_per_step / step_time_s / peak_flops
