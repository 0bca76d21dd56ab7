"""Collective-backend availability probe (counterpart of
apex_tpu/transformer/_backend_util.py).

The JAX package's names, answered for this process: `HAS_UCC` says
whether this torch.distributed build has the UCC backend (the
reference's `apex.transformer._ucc_util.HAS_UCC`),
`backend_available(name)` whether a platform of that name is live here
('gpu': a CUDA card, 'cpu': always, 'tpu': never in this package), and
`default_backend()` the platform the port's entry points run on by
default ('gpu' with a card, else 'cpu').
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["HAS_UCC", "backend_available", "default_backend"]

HAS_UCC = bool(dist.is_available() and dist.is_ucc_available())


def backend_available(name: str) -> bool:
    """True if a platform with this name ('gpu', 'cpu', 'tpu') is
    available to this process, not merely the default one."""
    if name == "gpu":
        return torch.cuda.is_available()
    return name == "cpu"


def default_backend() -> str:
    return "gpu" if torch.cuda.is_available() else "cpu"
