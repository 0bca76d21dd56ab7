"""Parallel RNG management and activation checkpointing (counterpart of
apex_tpu/transformer/tensor_parallel/random.py).

Keys.  The JAX package's `jax.random` keys are `torch.Generator`s here.
A JAX key is a value, so a recomputation that is handed the same key
draws the same bits; a generator is a state that every draw moves on.
So the derivations below never draw from the key they are given:
`fold_in(key, data)` and `split(key, n)` hash the key's state
(`Generator.get_state()`, read on the host for a CPU or a CUDA
generator alike) with their data into fresh generators, and leave the
key where it was.  A region recomputed under `checkpoint` that derives
its generators from a key handed in gets the same generators, and so
the same bits, both times.  Only a consumer (a dropout mask, the flash
kernels' seed) draws, from a generator it derived itself.

Tensor parallelism (apex_tpu/transformer/tensor_parallel/random.py:
33-159): `model_parallel_fold_in` folds in this process's rank in the tp
group of `parallel.mesh` (0 without one), so the tp ranks draw different
dropout masks from one key, and the distributed activation storage
(`split_tensor_into_1d_equal_chunks`, `gather_split_1d_tensor`,
`checkpoint_with_distributed_saved_activations`) runs over that group.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch
import torch.utils.checkpoint as _ckpt

from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.mesh import TP_AXIS

_MODEL_PARALLEL_RNG = "model-parallel-rng"


def _derive(key: torch.Generator, tag: int, data: int) -> torch.Generator:
    """A fresh generator on `key`'s device, seeded from a hash of `key`'s
    state, `tag` and `data`; `key` is not advanced."""
    h = hashlib.blake2b(digest_size=8)
    h.update(key.get_state().numpy().tobytes())
    h.update(int(tag).to_bytes(1, "little"))
    h.update(int(data).to_bytes(8, "little", signed=True))
    seed = int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)
    return torch.Generator(device=key.device).manual_seed(seed)


def fold_in(key: torch.Generator, data: int) -> torch.Generator:
    """≡ `jax.random.fold_in`: a new key from `key` and the integer
    `data`, a pure function of both (`key` is not advanced)."""
    return _derive(key, 0, data)


def split(key: torch.Generator, num: int = 2) -> list:
    """≡ `jax.random.split`: `num` new keys from `key`, a pure function
    of it (`key` is not advanced)."""
    return [_derive(key, 1, i) for i in range(num)]


def model_parallel_fold_in(key: torch.Generator, axis_name: str = TP_AXIS):
    """Per-tp-rank key ≡ seed + 2718 + tp_rank (the JAX package's
    `model_parallel_fold_in`, there `lax.axis_index` of the tp axis; here
    this process's rank in the tp group, 0 without one)."""
    return fold_in(key, 2718 + M.group_rank(M.group_of(axis_name)))


class RNGStatesTracker:
    """Named key registry ≡ the JAX package's `RNGStatesTracker`."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_ = {}

    def get_states(self):
        return dict(self.states_)

    def set_states(self, states):
        self.states_ = dict(states)

    def add(self, name, seed_or_key):
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        if isinstance(seed_or_key, int):
            seed_or_key = torch.Generator().manual_seed(seed_or_key)
        self.states_[name] = seed_or_key

    def fork(self, name=_MODEL_PARALLEL_RNG):
        """Split off a fresh key under `name` and return it (the
        functional analogue of the `with tracker.fork():` context)."""
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        self.states_[name], sub = split(self.states_[name])
        return sub


_GLOBAL_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    """≡ get_cuda_rng_tracker."""
    return _GLOBAL_TRACKER


def model_parallel_seed(seed: int,
                        tracker: Optional[RNGStatesTracker] = None):
    """≡ model_parallel_cuda_manual_seed: install the "default" key
    (`seed`) and the "model-parallel-rng" key (`seed + 2718`) into the
    tracker (the global one unless given)."""
    t = tracker or _GLOBAL_TRACKER
    t.reset()
    t.add("default", torch.Generator().manual_seed(seed))
    t.add(_MODEL_PARALLEL_RNG, torch.Generator().manual_seed(seed + 2718))
    return t


def checkpoint(fn, *args, policy=None, **kw):
    """Activation recomputation ≡ the JAX package's `checkpoint`:
    `fn(*args, **kw)` keeps only its inputs for the backward, which runs
    it again.  `policy` (selective checkpointing) is what
    `torch.utils.checkpoint.create_selective_checkpoint_contexts` takes:
    a policy function or a list of ops whose outputs are kept.  The
    global RNG states are not stashed: the port draws from explicit
    generators (module docstring)."""
    extra = {}
    if policy is not None:
        extra["context_fn"] = (
            lambda: _ckpt.create_selective_checkpoint_contexts(policy))
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False, **extra, **kw)


def split_tensor_into_1d_equal_chunks(x, axis_name: str = TP_AXIS):
    """This rank's share of the flattened activation over the tp group
    (all of it without one); a size the group does not divide raises."""
    group = M.group_of(axis_name)
    n = M.group_size(group)
    flat = x.reshape(-1)
    if flat.shape[0] % n:
        raise ValueError(f"split_tensor_into_1d_equal_chunks: {flat.shape[0]}"
                         f" elements are not divisible by {n} ranks")
    per = flat.shape[0] // n
    return flat[M.group_rank(group) * per:(M.group_rank(group) + 1) * per]


def gather_split_1d_tensor(chunk, axis_name: str = TP_AXIS):
    """The inverse gather: every rank's chunk in rank order (its
    gradient is the reduce-scatter, the JAX `all_gather`'s transpose)."""
    from apex_tpu_torch.parallel.collectives import (
        gather_from_sequence_parallel_region)

    return gather_from_sequence_parallel_region(chunk, axis_name)


def checkpoint_with_distributed_saved_activations(fn,
                                                  axis_name: str = TP_AXIS):
    """Returns g(x, *args) ≡ checkpoint(fn)(x, *args) that keeps this
    rank's 1/tp share of `x` for the backward and all-gathers it back
    when the backward recomputes.  The split and the gather are the
    Megatron pairs (split forward / gather backward outside, gather
    forward / split backward inside), which keep the gradient of a
    replicated `x` exact."""
    from apex_tpu_torch.parallel.collectives import (
        gather_from_sequence_parallel_region_no_tp_grad,
        scatter_to_sequence_parallel_region)

    def g(x, *args):
        chunk = scatter_to_sequence_parallel_region(x.reshape(-1, 1),
                                                    axis_name)
        shape, dtype = x.shape, x.dtype

        def inner(ck, *a):
            full = gather_from_sequence_parallel_region_no_tp_grad(
                ck, axis_name)
            return fn(full.reshape(shape).to(dtype), *a)

        return checkpoint(inner, chunk, *args)

    return g


def init_checkpointed_activations_memory_buffer(*_args, **_kw):
    """No-op, as in the JAX package: the allocator owns activation
    memory; the distributed storage is
    `checkpoint_with_distributed_saved_activations`."""
    return None
