"""The collective vocabulary of the comms observatory (counterpart of
the vocabulary half of apex_tpu/monitor/comms/hlo.py).

The JAX package's module is an optimized-HLO text parser:
`parse_module`, `computation_flops`, `instruction_flops`,
`parse_world_size`, and the `inventory_from_hlo` /
`comms_report(hlo_text=)` entries built on them read the program XLA
compiled.  An eager PyTorch step compiles no program, so that parser has
no input here and is not ported.  What replaces it is the inventory
recorder in `parallel.mesh`: the port's collective wrappers
(`all_reduce`, `reduce_scatter`, `all_gather`, `all_to_all`,
`exchange`) report each collective as they issue it, while
`comms.report.comms_report` runs the step once
(`comms.report.InventoryRecorder`).

What the other modules share is kept: the five collective kinds in the
JAX package's spelling (the timeline's classifier, the report's schema
and the allowlist all key on it) and the element sizes by HLO dtype
name, with the map from torch dtypes onto those names so that the port's
inventory spells a dtype as the JAX inventory does.
"""

from __future__ import annotations

# HLO primitive element type -> bytes.  token/opaque/tuple contribute 0.
_ITEMSIZE = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e4m3": 1, "f8e5m2": 1,
    "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# the five collective families the inventory tracks
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# torch dtype (its str) -> the HLO element type name
_TORCH_TO_HLO = {
    "torch.bool": "pred", "torch.int8": "s8", "torch.uint8": "u8",
    "torch.int16": "s16", "torch.uint16": "u16", "torch.float16": "f16",
    "torch.bfloat16": "bf16", "torch.int32": "s32", "torch.uint32": "u32",
    "torch.float32": "f32", "torch.int64": "s64", "torch.uint64": "u64",
    "torch.float64": "f64", "torch.complex64": "c64",
    "torch.complex128": "c128", "torch.float8_e4m3fn": "f8e4m3fn",
    "torch.float8_e5m2": "f8e5m2",
}


def itemsize(dtype: str) -> int:
    return _ITEMSIZE.get(dtype, 0)


def hlo_dtype(torch_dtype) -> str:
    """The HLO spelling of a torch dtype ("bf16" for torch.bfloat16),
    "?" for one HLO has no name for."""
    return _TORCH_TO_HLO.get(str(torch_dtype), "?")
