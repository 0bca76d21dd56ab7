"""OOM classification (counterpart of the `is_oom` half of
apex_tpu/monitor/compile/watermarks.py).

`is_oom(exc)` classifies the exception a crash guard just caught: an
allocator death (RESOURCE_EXHAUSTED, "out of memory", the word "OOM",
or PyTorch's `torch.OutOfMemoryError`) gets the full forensics
treatment.  `checkpoint.chaos.resume_guard` and the elastic
orchestrator's dumps call it.  The device-memory watermarks of the JAX
module wait for the port of the monitor package.
"""

from __future__ import annotations

import re

import torch

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                "Out of memory", "out of memory")
# a bare "OOM" must match as a word: "BLOOM" or "ZOOM" in a message is
# not an allocator death
_OOM_WORD = re.compile(r"\bOOM\b")


def is_oom(exc: BaseException) -> bool:
    """True when the exception is an allocator death worth full
    forensics: a `torch.OutOfMemoryError`, or one of the JAX package's
    markers in its repr."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    msg = repr(exc)
    return (any(m in msg for m in _OOM_MARKERS)
            or _OOM_WORD.search(msg) is not None)
