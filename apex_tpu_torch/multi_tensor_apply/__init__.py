"""apex_tpu_torch.multi_tensor_apply — one functor over parallel tensor
lists (counterpart of apex_tpu/multi_tensor_apply, itself ≡
apex.multi_tensor_apply, apex/multi_tensor_apply/multi_tensor_apply.py).

apex chunks hundreds of tensors into a few CUDA launches.  Here, as in
the JAX package, each tensor list is flattened into one 1-D buffer
(`optimizers.flat`), the functor runs once over the buffers, and its
outputs are cut back into tensors of the inputs' shapes.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from apex_tpu_torch.optimizers import flat as _flat

__all__ = ["MultiTensorApply", "multi_tensor_applier"]


class MultiTensorApply:
    """Callable dispatcher ≡ MultiTensorApply
    (apex/multi_tensor_apply/multi_tensor_apply.py:24-30).  `chunk_size`
    is kept for the signature: there is one call over each flat buffer,
    nothing is chunked."""

    available = True

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = int(chunk_size)

    def __call__(self, op: Callable, noop_flag,
                 tensor_lists: Sequence[Sequence[torch.Tensor]], *args):
        """`op(noop_flag, flat_buffers, *args)` returns one flat buffer
        (or None: the list is left as it was) per input list, as apex's
        `multi_tensor_applier(op, overflow_buf, [g, p, m, v], ...)` calls
        its functor.  Returns the tensor lists rebuilt from those
        buffers, as new tensors."""
        if not tensor_lists or not tensor_lists[0]:
            return tuple(list(tl) for tl in tensor_lists)
        n = len(tensor_lists[0])
        for tl in tensor_lists:
            if len(tl) != n:
                raise ValueError("tensor lists must have equal length "
                                 "(≡ multi_tensor_apply.cuh size check)")
        for tl in tensor_lists:
            if any(t.dtype != tl[0].dtype for t in tl):
                raise ValueError(
                    "all tensors in one list must share a dtype "
                    "(≡ multi_tensor_apply.cuh per-list dtype assert)")
        specs = [_flat.make_spec(dict(enumerate(tl)))
                 for tl in tensor_lists]
        flats = [_flat.flatten(list(tl), dtype=tl[0].dtype)
                 for tl in tensor_lists]
        outs = op(noop_flag, flats, *args)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        rebuilt = []
        for out, spec, tl in zip(outs, specs, tensor_lists):
            rebuilt.append(list(tl) if out is None
                           else _flat.unflatten_leaves(out, spec))
        return tuple(rebuilt)


multi_tensor_applier = MultiTensorApply(2048 * 32)
