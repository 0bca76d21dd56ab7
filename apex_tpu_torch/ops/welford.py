"""Per-channel batch statistics — the batch-norm compute core
(counterpart of apex_tpu/ops/welford.py).

`channel_sums` reduces a row-major (rows, C) view to fp32 per-channel
(Σx, Σx²); `batch_stats` turns them into the batch mean and (biased)
variance; `merge_stats` merges them across a process group, which is
the identity on one device (data parallelism across cards comes later,
ROADMAP Queue 1 item 12).

Two implementations of the sums:

  * `channel_sums_reference` — the plain PyTorch version.  CPU tensors
    run it, and `chip_smoke.py` holds the kernel against fp64 sums.
  * `_stats_partial_kernel` + `_stats_finish_kernel`, Triton kernels
    launched by `channel_sums_triton` for CUDA tensors.

On the TPU the JAX package takes its Pallas kernel only when forced
(`use_pallas_fusable`) and otherwise lets XLA fuse the reduction into
its neighbours; eager PyTorch fuses nothing, so here dispatch follows
the tensor's device alone, as for the LayerNorm forward.  The gradient
is the plain ds + 2·x·dq of the JAX package's `_channel_sums_bwd`.

Kernel note.  Replaces apex_tpu/ops/welford.py:_stats_kernel (launched
by channel_sums).  What bounds it on an H100: bytes — x is read once
(2 bytes an element in bf16) for 3 flops.  The TPU kernel carries one
(1, C) accumulator across its sequential grid; blocks on the card run
in any order, so each program of `_stats_partial_kernel` sums a fixed
run of rows for a block of at most 64 channels in fp32 registers
(tiles of `_TILE_ROWS` rows: a tile of the 64-channel stem output is
8 KB of contiguous bf16) and writes one partial row, and
`_stats_finish_kernel` sums the partials in a fixed order.  No atomics:
the sums are deterministic.  The runs are sized so about `_PROGRAMS`
programs cover the input, several per SM at every batch-norm shape of
ResNet-50, from (3,211,264, 64) to (12,544, 2048).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.ops._common import check_kernel_device

# triton.language, bound by `_jit` at the first launch: the kernels are
# compiled only on a machine with a card, and importing this module must
# not need triton
tl = None

_BLOCK_C = 64          # channels per program
_TILE_ROWS = 64        # rows per loop step
_PROGRAMS = 1024       # programs per launch, about


# --------------------------- plain PyTorch version ---------------------------

def channel_sums_reference(x2):
    """(Σx, Σx²) over the rows of (rows, C), fp32."""
    x = x2.float()
    return torch.sum(x, dim=0), torch.sum(x * x, dim=0)


# ------------------------------- Triton kernels ------------------------------

def _stats_partial_kernel(X, SP, QP, n_rows, n_cols, rows_per_prog,
                          TR: tl.constexpr, BC: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.program_id(1) * BC + tl.arange(0, BC)
    cmask = cols < n_cols
    acc_s = tl.zeros((TR, BC), dtype=tl.float32)
    acc_q = tl.zeros((TR, BC), dtype=tl.float32)
    r0 = pid * rows_per_prog
    r1 = tl.minimum(r0 + rows_per_prog, n_rows)
    for r in range(r0, r1, TR):
        rows = r + tl.arange(0, TR)
        m = (rows < r1)[:, None] & cmask[None, :]
        x = tl.load(X + rows.to(tl.int64)[:, None] * n_cols + cols[None, :],
                    mask=m, other=0.0).to(tl.float32)
        acc_s += x
        acc_q += x * x
    tl.store(SP + pid * n_cols + cols, tl.sum(acc_s, axis=0), mask=cmask)
    tl.store(QP + pid * n_cols + cols, tl.sum(acc_q, axis=0), mask=cmask)


def _stats_finish_kernel(SP, QP, S, Q, n_parts, n_cols, PARTS: tl.constexpr,
                         BC: tl.constexpr):
    """S, Q = the column sums of the (n_parts, n_cols) partials, PARTS
    rows at a time in a fixed order."""
    cols = tl.program_id(0) * BC + tl.arange(0, BC)
    cmask = cols < n_cols
    s = tl.zeros((BC,), dtype=tl.float32)
    q = tl.zeros((BC,), dtype=tl.float32)
    for p0 in range(0, n_parts, PARTS):
        parts = p0 + tl.arange(0, PARTS)
        m = (parts < n_parts)[:, None] & cmask[None, :]
        off = parts[:, None] * n_cols + cols[None, :]
        s += tl.sum(tl.load(SP + off, mask=m, other=0.0), axis=0)
        q += tl.sum(tl.load(QP + off, mask=m, other=0.0), axis=0)
    tl.store(S + cols, s, mask=cmask)
    tl.store(Q + cols, q, mask=cmask)


_JIT = {}


def _jit(fn):
    global tl
    if fn.__name__ not in _JIT:
        import triton
        import triton.language

        tl = triton.language
        _JIT[fn.__name__] = triton.jit(fn)
    return _JIT[fn.__name__]


def channel_sums_triton(x2):
    """Launch the two passes over a contiguous CUDA (rows, C) tensor of
    any float dtype: returns fp32 (Σx, Σx²), each (C,).  A strided view
    raises rather than being copied behind the caller's back.
    `channel_sums_triton.launches` counts calls."""
    if x2.ndim != 2 or not x2.is_contiguous():
        raise ValueError(f"channel sums need a contiguous (rows, C) tensor, "
                         f"got shape {tuple(x2.shape)} strides "
                         f"{x2.stride()}")
    if not x2.dtype.is_floating_point:
        raise TypeError(f"channel sums need a float tensor, got {x2.dtype}")
    rows, c = x2.shape
    s = torch.zeros(c, dtype=torch.float32, device=x2.device)
    q = torch.zeros_like(s)
    if rows and c:
        col_blocks = -(-c // _BLOCK_C)
        per = max(_TILE_ROWS, -(-rows * col_blocks // _PROGRAMS))
        per = -(-per // _TILE_ROWS) * _TILE_ROWS
        n_parts = -(-rows // per)
        sp = torch.empty((n_parts, c), dtype=torch.float32, device=x2.device)
        qp = torch.empty_like(sp)
        _jit(_stats_partial_kernel)[(n_parts, col_blocks)](
            x2, sp, qp, rows, c, per, TR=_TILE_ROWS, BC=_BLOCK_C,
            num_warps=4)
        _jit(_stats_finish_kernel)[(col_blocks,)](
            sp, qp, s, q, n_parts, c, PARTS=32, BC=_BLOCK_C, num_warps=4)
    channel_sums_triton.launches += 1
    return s, q


channel_sums_triton.launches = 0


class _ChannelSumsFn(torch.autograd.Function):
    """(Σx, Σx²) over rows with the JAX package's backward, dx = ds +
    2·x·dq in fp32, rounded once to x's dtype."""

    @staticmethod
    def forward(ctx, x2):
        ctx.save_for_backward(x2)
        if check_kernel_device(x2):
            return channel_sums_triton(x2)
        return channel_sums_reference(x2)

    @staticmethod
    def backward(ctx, ds, dq):
        (x2,) = ctx.saved_tensors
        dx = ds[None, :] + 2.0 * x2.float() * dq[None, :]
        return dx.to(x2.dtype)


# --------------------------------- public API -------------------------------

def channel_sums(x2):
    """(sum, sumsq) over rows of a (rows, C) tensor, fp32 (≡ the JAX
    package's `channel_sums`).  CPU tensors run the plain version; CUDA
    tensors run the Triton kernels or raise."""
    return _ChannelSumsFn.apply(x2)


def batch_stats(x, reduce_axes):
    """Per-channel (mean, var, count) reducing over `reduce_axes` (≡ the
    JAX package's `batch_stats`); the channel dim is the one axis not
    reduced.  A contiguous channels-last x (NHWC, reducing (0, 1, 2)) is
    viewed as (rows, C) for free, and a strided one raises rather than
    being copied; another reduction order is permuted into one copy
    first, as the JAX package transposes."""
    ndim = x.ndim
    reduce_axes = tuple(a % ndim for a in reduce_axes)
    (chan,) = [a for a in range(ndim) if a not in reduce_axes]
    perm = list(reduce_axes) + [chan]
    if perm == list(range(ndim)):
        x2 = x.view(-1, x.shape[chan])
    else:
        x2 = x.permute(perm).reshape(-1, x.shape[chan])
    count = x2.shape[0]
    s, q = channel_sums(x2)
    mean = s / count
    var = torch.clamp_min(q / count - mean * mean, 0.0)
    return mean, var, count


def merge_stats(mean, var, count, process_group=None):
    """Merge per-device (mean, var, count) across `process_group` (≡ the
    JAX package's `merge_stats` over a mesh axis).  On one device — no
    group, or a group of one rank — it is the identity."""
    if process_group is not None:
        if dist.get_world_size(process_group) > 1:
            raise NotImplementedError(
                "merging batch statistics across ranks comes with "
                "multi-GPU data parallelism (ROADMAP Queue 1 item 12)")
    return mean, var, count
