"""Link-bandwidth table + analytic collective pricing (counterpart of
apex_tpu/monitor/comms/roofline.py: the same table rows, fallback and
ring formulas, so equal inputs give equal prices in both packages).

The comms sibling of `monitor.flops.DEVICE_BF16_PEAKS`: a per-device
interconnect bandwidth table and the standard ring-algorithm cost
formulas, so every collective in the inventory gets a predicted
wall-clock, the number the overlap analysis and the
comm-bound/compute-bound verdict divide by.

Bandwidth convention: BYTES/SECOND of aggregate per-device link
bandwidth.  The TPU rows are the JAX package's, from the public TPU
spec sheets (interchip interconnect per chip, all links, /8 for bytes).
The NVIDIA rows are the H100 data sheet's NVLink figures: 900 GB/s for
the SXM part (NVLink 4, 18 links) and 600 GB/s for the PCIe card over
its NVLink bridge.  All of them are LINK PEAKS quoted by the vendor,
not measurements: a real ring sees a fraction of link peak depending on
topology and message size, and the one-card machines this port has run
on have no link to measure.  Treat the predictions as a roofline;
`device_link_bandwidth(override=...)` and `crosscheck_rank_timing` bring
a measured number in.

Ring-algorithm cost model over n participants for D bytes of *input*
(the operand bytes the inventory recorded):

    all-reduce          2 (n-1)/n * D / bw     (reduce-scatter + all-gather phases)
    reduce-scatter        (n-1)/n * D / bw     (D = full un-scattered input)
    all-gather            (n-1)   * D / bw     (D = this rank's shard; output = n*D)
    all-to-all            (n-1)/n * D / bw
    collective-permute              D / bw     (one hop, full operand)

n == 1 collectives (a tp collective on a tp=1 mesh) cost 0.
"""

from __future__ import annotations

from typing import Optional

from apex_tpu_torch.monitor.flops import _normalize_device_kind

# v5e aggregate ICI per chip: the fallback for unknown kinds (CPU runs
# included), as in the JAX package, so that predictions on unknown
# backends are stable table prices, never zero
V5E_ICI_BYTES_PER_S = 200e9  # 1600 Gbps

# normalized device kind -> aggregate per-device link bytes/s.  TPU
# rows: the public TPU spec sheets (v2 496 Gbps, v3 656 Gbps, v4 2400
# Gbps, v5e 1600 Gbps, v5p 4800 Gbps, v6e 3584 Gbps).  H100 rows:
# NVIDIA's H100 data sheet, NVLink peak (SXM 900 GB/s; PCIe 600 GB/s
# over the NVLink bridge) -- data-sheet peaks, not measurements.
DEVICE_ICI_BANDWIDTH = {
    "v2": 62e9,
    "v3": 82e9,
    "v4": 300e9,
    "v5e": 200e9,
    "v5p": 600e9,
    "v6e": 448e9,
    "h100-sxm": 900e9,
    "h100-pcie": 600e9,
}


def resolve_link_bandwidth(device_kind: Optional[str], *,
                           override: Optional[float] = None,
                           default: float = V5E_ICI_BYTES_PER_S,
                           ) -> "tuple[float, str]":
    """(bytes/s, source) with source one of "override" /
    "table:<kind>" / "default": the one resolution path that both
    `device_link_bandwidth` and `comms_report` price against."""
    if override is not None:
        return float(override), "override"
    norm = _normalize_device_kind(str(device_kind or ""))
    if norm in DEVICE_ICI_BANDWIDTH:
        return DEVICE_ICI_BANDWIDTH[norm], f"table:{norm}"
    return float(default), "default"


def device_link_bandwidth(device_kind: Optional[str] = None, *,
                          override: Optional[float] = None,
                          default: float = V5E_ICI_BYTES_PER_S) -> float:
    """Aggregate per-device link bytes/s, resolved from the device kind.

    Same contract as `flops.device_peak_flops`: `override` wins
    outright; device_kind=None reads `torch.cuda.get_device_name()`
    when a card is present; an unknown kind, or no card, falls back to
    the v5e number so that CPU predictions are stable table prices."""
    if override is None and device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return default
        device_kind = torch.cuda.get_device_name()
    return resolve_link_bandwidth(device_kind, override=override,
                                  default=default)[0]


def collective_seconds(kind: str, operand_bytes: int, group_size: int,
                       bandwidth: float) -> float:
    """Predicted ring-algorithm seconds for one collective (see the
    module docstring for the per-kind formulas and what D means)."""
    n, d = int(group_size), float(operand_bytes)
    if n <= 1 or d <= 0 or bandwidth <= 0:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * d / bandwidth
    if kind == "reduce-scatter":
        return (n - 1) / n * d / bandwidth
    if kind == "all-gather":
        return (n - 1) * d / bandwidth
    if kind == "all-to-all":
        return (n - 1) / n * d / bandwidth
    if kind == "collective-permute":
        return d / bandwidth
    return d / bandwidth  # unknown kind: one full traversal
