"""apex_tpu_torch.tune — kernel autotuning (counterpart of apex_tpu/tune).

Three pieces, as in the JAX package:

  * cache   — the persistent JSON config store keyed by (device kind,
              op, shape/dtype attrs), in the JAX package's schema and
              key spelling, so one file serves both packages; committed
              defaults live in defaults.py; $APEX_TPU_TUNE_CACHE moves
              the file, APEX_TPU_TUNE=0 disables every lookup.
  * tuned() — the lookup a kernel's entry point makes when its caller
              passed no explicit config: a host-side dict access (no
              device work, no host sync).  None on a miss, and the
              kernel keeps its heuristic, so an empty cache runs exactly
              the untuned kernels.
  * search  — the offline sweep (never inside a training step): times
              candidate configs on the card with CUDA events and records
              the winner.

What the port tunes: flash attention's `heads_per_step`
(ops/flash_attention.py; the CUDA tile stays 64 x 64), and the serving
path's `flash_decode` heads_per_step (validated; the decode kernel
tiles as it does) and paged-KV page size (`serve_page`).  The key
functions below are the JAX package's, all of them, so keys written by
either package are read by the other; the row-block and flat-optimizer
axes (`tuned_row_block`, `opt_flat`) are not consulted by the port's
Triton launchers, which have no rows-per-program knob yet.
"""

from __future__ import annotations

import numpy as np

from apex_tpu_torch.tune.cache import (  # noqa: F401
    ENV_CACHE_PATH,
    ENV_DISABLE,
    SCHEMA_VERSION,
    cache_path,
    canonical_kind,
    device_kind,
    fingerprint,
    invalidate,
    lookup,
    make_key,
    record,
    reset_stats,
    stats,
)


def dtype_name(dtype) -> str:
    """A dtype as the JAX package's keys spell it (`jnp.dtype(d).name`):
    `torch.bfloat16` → "bfloat16", never "torch.bfloat16"; None is the
    bench dtype, bfloat16; a name passes through as it is."""
    if dtype is None:
        return "bfloat16"
    if isinstance(dtype, str):
        return dtype
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    return np.dtype(dtype).name


def pow2_bucket(n: int) -> int:
    """Round up to the next power of two — the size coordinate of keys
    whose exact value should not fragment the cache (row counts)."""
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def flash_attrs(b, h, sq, sk, d, dtype, causal, bias="none", seg=False):
    """The one definition of the `flash_sdpa` lookup-key attrs, shared by
    the runtime lookup (ops/flash_attention.py), the sweep (search.py)
    and the committed defaults (defaults.py)."""
    return dict(b=int(b), h=int(h), sq=int(sq), sk=int(sk), d=int(d),
                dtype=dtype_name(dtype), causal=bool(causal),
                bias=bias, seg=bool(seg))


def decode_attrs(n_slots, q_len, hq, hkv, d, page_size, dtype):
    """The `flash_decode` lookup-key attrs; n_slots is pow2-bucketed so
    nearby concurrencies share an entry."""
    return dict(slots=pow2_bucket(n_slots), ql=int(q_len), hq=int(hq),
                hkv=int(hkv), d=int(d), page=int(page_size),
                dtype=dtype_name(dtype))


def moe_router_attrs(tokens, n_experts, top_k, dtype):
    """The `moe_router` lookup-key attrs (the JAX package's MoE router;
    no consumer in the port yet); tokens pow2-bucketed."""
    return dict(rows=pow2_bucket(tokens), experts=int(n_experts),
                k=int(top_k), dtype=dtype_name(dtype))


def serve_page_attrs(n_kv_heads, head_dim, dtype):
    """The `serve_page` lookup-key attrs: the paged KV cache's page
    size, keyed by the cache layout alone."""
    return dict(hkv=int(n_kv_heads), d=int(head_dim),
                dtype=dtype_name(dtype))


def overlap_attrs(path, rows, width, axis_size, dtype):
    """The `overlap_chunks` lookup-key attrs (the JAX package's chunked
    compute/collective overlap; no consumer in the port yet); rows
    pow2-bucketed."""
    return dict(path=str(path), rows=pow2_bucket(rows), width=int(width),
                ax=int(axis_size), dtype=dtype_name(dtype))


def tuned(op: str, attrs=None, **kw):
    """Tuned config for (op, attrs) on this device kind, or None.  attrs
    values are ints, bools or strings (canonicalized into the key)."""
    a = dict(attrs or {})
    a.update(kw)
    return lookup(op, a)
