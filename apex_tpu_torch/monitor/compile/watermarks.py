"""Device-memory watermarks and OOM classification (counterpart of
apex_tpu/monitor/compile/watermarks.py).

`device_memory_stats` is one card's allocator snapshot under the JAX
package's names: `bytes_in_use` and `peak_bytes_in_use` are PyTorch's
caching allocator's allocated bytes now and at their peak (the peak is
`torch.cuda.max_memory_allocated`), `bytes_limit` the card's total
memory (`torch.cuda.mem_get_info`), beside `bytes_reserved` /
`peak_bytes_reserved` (what the allocator holds from the driver) and
`bytes_free` (free on the card).  Reading it is a host-side query (no
stream sync, no effect on the step), so the logger can stamp the
watermarks into every record.  Without a card (a CPU run) every helper
returns None or None fields, as the JAX package's do on a backend that
does not report; the JSONL schema treats `hbm_*` as optional-null.

`is_oom(exc)` classifies the exception a crash guard just caught: an
allocator death (`torch.OutOfMemoryError`, RESOURCE_EXHAUSTED, "out of
memory", or the word "OOM") gets the full forensics treatment.
`FlightRecorder.guard`, `checkpoint.chaos.resume_guard` and the elastic
orchestrator's dumps call it.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

# the known watermark fields (the JAX package's names); hbm_watermarks()
# always emits these three — None when the device withholds one — and
# passes any EXTRA integer-valued stats key through under the same hbm_
# prefix (the JSONL schema treats every hbm_* as an optional null-legal
# scalar)
WATERMARK_FIELDS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                "Out of memory", "out of memory")
# a bare "OOM" must match as a word: "BLOOM" or "ZOOM" in a message is
# not an allocator death
_OOM_WORD = re.compile(r"\bOOM\b")


def _card(device) -> Optional[torch.device]:
    if not torch.cuda.is_available():
        return None
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    if dev.type != "cuda":
        return None
    return dev


def device_memory_stats(device=None) -> Optional[dict]:
    """One card's allocator snapshot, or None without a card (CPU).
    device defaults to the current card; a CPU device gives None."""
    dev = _card(device)
    if dev is None:
        return None
    try:
        s = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
    except RuntimeError:
        return None
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "peak_bytes_reserved": s.get("reserved_bytes.all.peak", 0),
            "bytes_free": free}


def _as_int(value) -> Optional[int]:
    """Coerce one allocator stat to an int, or None — a value that does
    not coerce costs that FIELD, never the record (bools are not byte
    counts)."""
    if isinstance(value, bool):
        return None
    try:
        return int(value)
    except (TypeError, ValueError):
        return None


def hbm_watermarks(device=None, stats: Optional[dict] = None) -> dict:
    """The per-record watermark fields: always the three
    WATERMARK_FIELDS (`hbm_bytes_in_use` / `hbm_peak_bytes_in_use` /
    `hbm_bytes_limit`, None when the device withholds one), plus an
    `hbm_<key>` passthrough for every EXTRA integer-valued key.  `stats`
    overrides the device read (tests feed fake dicts)."""
    if stats is None:
        stats = device_memory_stats(device) or {}
    out = {f"hbm_{k}": _as_int(stats.get(k)) for k in WATERMARK_FIELDS}
    for k, v in stats.items():
        if k in WATERMARK_FIELDS or not isinstance(k, str):
            continue
        iv = _as_int(v)
        if iv is not None:
            out[f"hbm_{k}"] = iv
    return out


def all_device_memory_stats() -> Optional[dict]:
    """{card index: memory stats} over the visible cards, or None when
    none reports — the crash-dump form (an OOM on card 3 of 4 should
    name card 3)."""
    if not torch.cuda.is_available():
        return None
    out = {}
    for i in range(torch.cuda.device_count()):
        s = device_memory_stats(i)
        if s is not None:
            out[str(i)] = s
    return out or None


def is_oom(exc: BaseException) -> bool:
    """True when the exception is an allocator death worth full
    forensics: a `torch.OutOfMemoryError`, or one of the JAX package's
    markers in its repr."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    msg = repr(exc)
    return (any(m in msg for m in _OOM_MARKERS)
            or _OOM_WORD.search(msg) is not None)
