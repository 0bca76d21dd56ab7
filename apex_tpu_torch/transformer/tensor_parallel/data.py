"""Batch data distribution (counterpart of
apex_tpu/transformer/tensor_parallel/data.py).

`broadcast_data` checks the entries' dtype, moves them to the caller's
device and, when the world has more than one rank, broadcasts global
rank 0's batch to every rank (the JAX package's
`multihost_utils.broadcast_one_to_all`), through `parallel.mesh`'s
`broadcast` wrapper, which the comms inventory sees as one all-reduce
(rank 0's values summed with the other ranks' zeros, as in the JAX
package).  Every rank passes
entries of the same shapes; rank 0's values win.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.parallel import mesh as M


def _check_data_types(keys, data, target_dtype):
    for key in keys:
        if data[key].dtype != target_dtype:
            raise ValueError(
                f"{key} has data type {data[key].dtype} which "
                f"is different than {target_dtype}")


def broadcast_data(keys, data, datatype=torch.int32, device=None):
    """{key: data[key]} for `keys` on `device` (the card unless the
    caller asks for another), each rank ending with global rank 0's
    values.  Raises ValueError for an entry whose dtype is not
    `datatype`."""
    out = {k: torch.as_tensor(data[k]) for k in keys}
    _check_data_types(keys, out, datatype)
    dev = resolve_device(device)
    out = {k: v.to(dev) for k, v in out.items()}
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        for v in out.values():
            M.broadcast(v, src=0, group=dist.group.WORLD)
    return out
