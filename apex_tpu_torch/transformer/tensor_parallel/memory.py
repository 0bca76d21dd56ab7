"""Preallocated memory buffers for checkpointed activations (counterpart
of apex_tpu/transformer/tensor_parallel/memory.py).

`MemoryBuffer` is one arena, `torch.empty(numel, dtype, device)`, that
hands out views of it: apex's own semantics (a tensor `add` returns
shares the arena's storage), where the JAX package could only copy.
`RingMemBuffer` cycles through a few such arenas.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops._common import resolve_device


class MemoryBuffer:
    """A fixed-size arena handing out views: `add(shape)` returns the
    next `prod(shape)` elements as a tensor of that shape, `reset()`
    frees them all."""

    def __init__(self, name, numel, dtype, track_usage=False, device=None):
        self.name = name
        self.numel = numel
        self.dtype = dtype
        self.data = torch.empty(numel, dtype=dtype,
                                device=resolve_device(device))
        self._start = 0
        self.in_use_value = 0
        self.total_value = 0
        self.track_usage = track_usage

    def reset(self):
        self._start = 0

    def is_in_use(self):
        return self._start > 0

    def add(self, shape):
        size = 1
        for s in shape:
            size *= int(s)
        if self._start + size > self.numel:
            raise RuntimeError("MemoryBuffer out of space")
        view = self.data[self._start:self._start + size].view(tuple(shape))
        self._start += size
        if self.track_usage:
            self.in_use_value += size
            self.total_value += size
        return view

    def get_data(self):
        return self.data


class RingMemBuffer:
    """`num_buffers` arenas handed out round-robin; handing out one whose
    views are still in use raises."""

    def __init__(self, name, num_buffers, numel, dtype, track_usage=False,
                 device=None):
        self.num_buffers = num_buffers
        self.buffers = [MemoryBuffer(f"{name} {i}", numel, dtype,
                                     track_usage, device)
                        for i in range(num_buffers)]
        self._index = -1

    def get_next_buffer(self):
        self._index = (self._index + 1) % self.num_buffers
        buf = self.buffers[self._index]
        if buf.is_in_use():
            raise RuntimeError("buffer is already in use")
        return buf
