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

Tensor parallelism is tp=1 in the port: `model_parallel_fold_in` folds
in the rank it is given (0), and the distributed activation storage
(`split_tensor_into_1d_equal_chunks`, `gather_split_1d_tensor`,
`checkpoint_with_distributed_saved_activations`) runs at one rank and
refuses more, until TP > 1 comes (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch
import torch.utils.checkpoint as _ckpt

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


def model_parallel_fold_in(key: torch.Generator, tp_rank: int = 0):
    """Per-tp-rank key ≡ seed + 2718 + tp_rank (the JAX package's
    `model_parallel_fold_in`, there `lax.axis_index` of the tp axis; here
    the rank, 0 at tp=1)."""
    return fold_in(key, 2718 + tp_rank)


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


def _one_rank(what: str, world_size: int):
    if world_size != 1:
        raise NotImplementedError(
            f"{what} over {world_size} tensor-parallel ranks comes with "
            "TP > 1, ROADMAP Queue 1 item 13")


def split_tensor_into_1d_equal_chunks(x, world_size: int = 1, rank: int = 0):
    """This rank's share of the flattened activation (the JAX package's,
    over the tp axis): at tp=1, all of it."""
    _one_rank("split_tensor_into_1d_equal_chunks", world_size)
    flat = x.reshape(-1)
    per = flat.shape[0] // world_size
    return flat[rank * per:(rank + 1) * per]


def gather_split_1d_tensor(chunk, world_size: int = 1):
    """The inverse gather: at tp=1, the chunk itself."""
    _one_rank("gather_split_1d_tensor", world_size)
    return chunk


def checkpoint_with_distributed_saved_activations(fn, world_size: int = 1):
    """Returns g(x, *args) ≡ checkpoint(fn)(x, *args) that keeps this
    rank's 1/tp share of `x` for the backward and gathers it back when
    the backward recomputes; at tp=1 the share is all of `x`."""
    _one_rank("checkpoint_with_distributed_saved_activations", world_size)

    def g(x, *args):
        chunk = split_tensor_into_1d_equal_chunks(x, world_size)
        shape = x.shape

        def inner(ck, *a):
            return fn(gather_split_1d_tensor(ck, world_size).reshape(shape),
                      *a)

        return checkpoint(inner, chunk, *args)

    return g


def init_checkpointed_activations_memory_buffer(*_args, **_kw):
    """No-op, as in the JAX package: the allocator owns activation
    memory; the distributed storage is
    `checkpoint_with_distributed_saved_activations`."""
    return None
