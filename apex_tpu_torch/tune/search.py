"""Offline kernel-config search (counterpart of apex_tpu/tune/search.py).

Offline only: each candidate config is timed on its own, never inside a
training step, and the winner is written to the cache with
`cache.record`; the kernels pick it up at their next call through
`tune.tuned()`.  `chip_smoke.py` runs `tune_flash` on the card at the
MHA bench shape and prints every candidate's time.

Unlike the JAX sweep, no candidate's failure is caught and skipped: a
candidate the port's kernels cannot run is left out before timing by a
static rule (`flash_candidates`), and any other failure raises.  The
row-block and flat-optimizer sweeps (`tune_row_block`, `tune_opt_flat`)
are not ported: the port's launchers keep fixed plans (the package
docstring says why).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

from apex_tpu_torch.tune import cache

# the packing factors a sweep tries (the JAX validation admits 1..16)
_HEADS_PER_STEP = (1, 2, 4, 8, 16)
# the block a candidate names for the tuner's validation, never None,
# because that validation counts a None block as 1024 (hp * 1024 * 1024 >
# 1M would throw every packed candidate away); the CUDA kernels keep their
# own tiles (the forward 192 or 128 x 128, the backward 64 x 64) whatever
# it says
_CUDA_TILE = 64


@contextlib.contextmanager
def forced(op: str, attrs: Dict[str, Any], config: Dict[str, Any]):
    """Temporarily pin (op, attrs) -> config in the in-memory cache, so a
    kernel with no explicit config knob can be timed at a candidate."""
    key = cache.make_key(op, attrs)
    mem = cache._ensure_loaded()
    missing = object()
    old = mem.get(key, missing)
    mem[key] = {"config": dict(config)}
    try:
        yield
    finally:
        if old is missing:
            mem.pop(key, None)
        else:
            mem[key] = old


# ------------------------------ flash attention -----------------------------

def flash_candidates(h: int, sq: int, sk: int) -> List[Dict[str, int]]:
    """The candidates the port's kernels run, by a static rule: blocks of
    `_CUDA_TILE` (64, or the largest power-of-two block under it that
    divides the sequence; validated, not read by the kernels) and each packing factor in (1, 2, 4, 8, 16)
    that divides the head count — the packed forward runs any such
    factor, and the backward route falls back to the unpacked fused
    kernel where hp * sk * d passes the packed cap.  No other candidate
    is timed, and none is dropped for failing."""
    from apex_tpu_torch.ops.flash_attention import _pick_block

    bq, bk = _pick_block(sq, cap=_CUDA_TILE), _pick_block(sk, cap=_CUDA_TILE)
    if bq is None or bk is None:
        raise ValueError(f"no power-of-two block divides sq={sq} / sk={sk}: "
                         f"flash attention consults no tuned entry there")
    return [{"block_q": bq, "block_k": bk, "heads_per_step": hp}
            for hp in _HEADS_PER_STEP if h % hp == 0]


def flash_attrs(b, h, s, d, dtype, causal, bias="none", seg=False):
    """Self-attention (sq == sk == s) flash key attrs, by the shared
    definition in apex_tpu_torch.tune.flash_attrs."""
    from apex_tpu_torch.tune import flash_attrs as _shared

    return _shared(b, h, s, s, d, dtype, causal, bias=bias, seg=seg)


def _time_fn(torch, fn, device, iters, warmup, reps=2) -> float:
    """Best-of-`reps` mean seconds per call after `warmup` calls: CUDA
    events around `iters` calls on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            t = time.perf_counter() - t0
        best = min(best, t / iters)
    return best


def tune_flash(b: int, h: int, s: int, d: int, *, dtype=None,
               causal: bool = True, seg: bool = False, iters: int = 10,
               warmup: int = 2, write: bool = True, device=None,
               meta: Optional[Dict[str, Any]] = None,
               verbose: bool = False
               ) -> Tuple[Dict[str, int], List[Tuple[Dict, float]]]:
    """Sweep flash attention's forward + backward (the gradient of the
    output against itself as cotangent, as the JAX sweep times it) over
    `flash_candidates` at one (shape, dtype) point, on the card unless
    `device` says otherwise; returns (best config, [(config, seconds)])
    and records the winner with its ms, the count swept, every
    candidate's ms and `meta` (the card's name and power limit, say)."""
    import torch

    from apex_tpu_torch.ops._common import resolve_device
    from apex_tpu_torch.ops.flash_attention import flash_attention

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
               .to(dtype).requires_grad_(True) for _ in range(3))
    seg_ids = (torch.zeros((b, s), dtype=torch.int32, device=dev)
               if seg else None)

    results = []
    for cand in flash_candidates(h, s, s):
        def fwd_bwd(cand=cand):
            out = flash_attention(
                q, k, v, causal=causal, segment_ids=seg_ids,
                block_q=cand["block_q"], block_k=cand["block_k"],
                heads_per_step=cand["heads_per_step"])
            return torch.autograd.grad(out, (q, k, v), out.detach())

        t = _time_fn(torch, fwd_bwd, dev, iters, warmup)
        results.append((cand, t))
        if verbose:
            print(f"  flash {cand}: {t * 1e3:.4f} ms", flush=True)
    results.sort(key=lambda r: r[1])
    best, best_t = results[0]
    if write:
        cache.record(
            "flash_sdpa", flash_attrs(b, h, s, d, dtype, causal, seg=seg),
            best, meta=dict(
                meta or {}, ms=round(best_t * 1e3, 4), swept=len(results),
                candidates_ms={str(c["heads_per_step"]): round(t * 1e3, 4)
                               for c, t in results}))
    return best, results
