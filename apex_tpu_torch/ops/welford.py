"""Per-channel batch statistics — the batch-norm compute core
(counterpart of apex_tpu/ops/welford.py).

`channel_sums` reduces a row-major (rows, C) view to fp32 per-channel
(Σx, Σx²); `batch_stats` turns them into the batch mean and (biased)
variance; `merge_stats` merges them across a process group (one
all-reduce; the identity without a group).

Two implementations of the sums:

  * `channel_sums_reference` — the plain PyTorch version.  CPU tensors
    run it, and `chip_smoke.py` holds the kernel against fp64 sums.
  * the CUDA C++ kernel of `apex_tpu_torch/csrc/welford.cu`, launched by
    `channel_sums_cuda` under the host plan `sums_plan`, for CUDA tensors.

On the TPU the JAX package takes its Pallas kernel only when forced
(`use_pallas_fusable`) and otherwise lets XLA fuse the reduction into
its neighbours; eager PyTorch fuses nothing, so here dispatch follows
the tensor's device alone, as for the LayerNorm forward.  The gradient
is the plain ds + 2·x·dq of the JAX package's `_channel_sums_bwd`.

Kernel note.  Replaces apex_tpu/ops/welford.py:_stats_kernel (launched
by channel_sums).  What bounds it on an H100: bytes — x is read once
(2 bytes an element in bf16) for 3 flops.  The TPU kernel carries one
(1, C) accumulator across its sequential grid; blocks on the card run
in any order, so one launch a call runs about a block an SM, each
owning every channel (up to 2048 in 16-bit) of a contiguous run of rows:
a thread sums one 16-byte vector of channels of every R-th row in fp32
registers, several 16-byte loads in flight; the block's threads meet in
shared memory, the blocks of a thread-block cluster in rank order
through distributed shared memory, and the last cluster to finish
(an integer ticket tells it) sums the clusters' partials in cluster
order.  No float atomics: the same bits every run.  The plan
(`sums_plan`) covers every batch-norm shape of ResNet-50, from
(3,211,264, 64) to (12,544, 2048); the source note (csrc/welford.cu)
has the details.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from apex_tpu_torch.ops._common import (check_kernel_device,
                                        sm_count as _sm_count)
from apex_tpu_torch.parallel import mesh as M

# the plan's constants (csrc/welford.cu): threads a block, 16-byte loads
# a thread keeps in flight, blocks an SM, the most blocks a cluster
SUMS_THREADS = 256
SUMS_UNROLL = 8
SUMS_BLOCKS_PER_SM = 1
SUMS_MAX_CLUSTER = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}
_LIB = None
# (device index, stream) -> the int32 ticket the kernel's clusters take
# (0 between calls: the last cluster's atomicInc wraps it back)
_TICKETS = {}


# --------------------------- plain PyTorch version ---------------------------

def channel_sums_reference(x2):
    """(Σx, Σx²) over the rows of (rows, C), fp32."""
    x = x2.float()
    return torch.sum(x, dim=0), torch.sum(x * x, dim=0)


# -------------------------------- CUDA kernel --------------------------------

class SumsPlan(NamedTuple):
    """What `csrc/welford.cu` runs: `blocks` blocks of rows (a multiple
    of `cluster`, the blocks of a thread-block cluster) of
    `rows_per_block` rows, times `col_blocks` column chunks of `chunk`
    vectors, loads `load_width` bytes wide (one vector: 16 bytes, or an
    element)."""
    blocks: int
    rows_per_block: int
    cluster: int
    col_blocks: int
    chunk: int
    load_width: int


def sums_plan(rows, c, itemsize, sms, align=16):
    """The kernel's plan for a contiguous (rows, c) tensor of
    `itemsize`-byte elements on a card of `sms` SMs, where `align` bytes
    divide its base.  A thread loads 16-byte vectors where the rows'
    bytes and the base are 16-byte multiples, else one element; a block
    of `SUMS_THREADS` threads covers up to that many vectors of a row
    (a column chunk) and R = threads / vectors rows at a time.
    `SUMS_BLOCKS_PER_SM` blocks an SM split the rows (fewer where that
    would leave a block under R x `SUMS_UNROLL` rows), in clusters of
    the most blocks, up to `SUMS_MAX_CLUSTER`, that divide their number
    (6 of 132 on an H100); the blocks' runs are as even as whole rows
    allow."""
    if rows < 0 or c < 1:
        raise ValueError(f"channel sums take rows >= 0 and c >= 1, got "
                         f"({rows}, {c})")
    width = 16 if align % 16 == 0 and c * itemsize % 16 == 0 else itemsize
    vecs = c * itemsize // width
    chunk = min(vecs, SUMS_THREADS)
    col_blocks = -(-vecs // chunk)
    slots = SUMS_THREADS // chunk
    if rows == 0:
        return SumsPlan(0, 0, 1, col_blocks, chunk, width)
    target = max(1, SUMS_BLOCKS_PER_SM * sms // col_blocks)
    want = max(1, min(target, -(-rows // (slots * SUMS_UNROLL))))
    cluster = max(k for k in range(1, SUMS_MAX_CLUSTER + 1)
                  if want % k == 0)
    return SumsPlan(want, -(-rows // want), cluster, col_blocks, chunk,
                    width)


def _bind(lib):
    """`lib` (a build of csrc/welford.cu) with its C entry's types."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apex_channel_sums.restype = i32
    lib.apex_channel_sums.argtypes = [i32, vp, i64, i32, vp, vp, vp, vp, i32,
                                      i32, i32, i32, i32, i32, vp]
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from apex_tpu_torch import csrc
        _LIB = _bind(csrc.load("welford"))
    return _LIB


def _ticket(device, stream):
    """The zeroed int32 ticket of calls on `stream` of `device`."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _launch(plan, x2, s, q):
    """Launch the kernel on the current stream under `plan`: s and q
    filled in place.  Counts the launch in `channel_sums_cuda.launches`."""
    rows, c = x2.shape
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    part = ticket = None
    if plan.blocks > plan.cluster:
        part = torch.empty((plan.blocks // plan.cluster, 2, c),
                           dtype=torch.float32, device=x2.device)
        ticket = _ticket(x2.device, stream)
    err = _lib().apex_channel_sums(
        _DTYPE_CODES[x2.dtype], x2.data_ptr(), rows, c, s.data_ptr(),
        q.data_ptr(), None if part is None else part.data_ptr(),
        None if ticket is None else ticket.data_ptr(), plan.blocks,
        plan.rows_per_block, plan.cluster, plan.col_blocks, plan.chunk,
        plan.load_width, stream)
    if err != 0:
        raise RuntimeError(f"channel sums kernel launch failed (plan "
                           f"{tuple(plan)}): CUDA error {err}")
    channel_sums_cuda.launches += 1


def channel_sums_cuda(x2):
    """Launch the kernel over a contiguous CUDA (rows, C) tensor of fp32,
    bf16, fp16 or fp64: returns fp32 (Σx, Σx²), each (C,), from one
    launch under `sums_plan`.  A strided view raises rather than being
    copied behind the caller's back.  `channel_sums_cuda.launches` counts
    launches."""
    if x2.ndim != 2 or not x2.is_contiguous():
        raise ValueError(f"channel sums need a contiguous (rows, C) tensor, "
                         f"got shape {tuple(x2.shape)} strides "
                         f"{x2.stride()}")
    if not x2.dtype.is_floating_point:
        raise TypeError(f"channel sums need a float tensor, got {x2.dtype}")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"channel sums kernel takes fp32/bf16/fp16/fp64, "
                        f"got {x2.dtype}")
    rows, c = x2.shape
    if rows == 0 or c == 0:
        z = torch.zeros(c, dtype=torch.float32, device=x2.device)
        return z, z.clone()
    s = torch.empty(c, dtype=torch.float32, device=x2.device)
    q = torch.empty_like(s)
    align = 16 if x2.data_ptr() % 16 == 0 else x2.element_size()
    plan = sums_plan(rows, c, x2.element_size(), _sm_count(x2.device),
                     align)
    _launch(plan, x2, s, q)
    return s, q


channel_sums_cuda.launches = 0


class _ChannelSumsFn(torch.autograd.Function):
    """(Σx, Σx²) over rows with the JAX package's backward, dx = ds +
    2·x·dq in fp32, rounded once to x's dtype."""

    @staticmethod
    def forward(ctx, x2):
        ctx.save_for_backward(x2)
        if check_kernel_device(x2):
            return channel_sums_cuda(x2)
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
    tensors run the CUDA kernel or raise."""
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


class _AllReduceSum(torch.autograd.Function):
    """Σ over the group with its transpose as the backward (≡ `lax.psum`
    under differentiation): the gradient of a summed value is the sum
    of the ranks' gradients of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return M.all_reduce(x.clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return M.all_reduce(g.clone(), "sum", ctx.group), None


def merge_stats(mean, var, count, process_group=None):
    """Merge per-rank (mean, var, count) across `process_group` (≡ the JAX
    package's `merge_stats`, the all_gather + welford_parallel merge of
    apex's SyncBatchNorm): one all-reduce of (n·mean, n·(var + mean²), n)
    and the parallel-variance identity.  The all-reduce differentiates
    as `psum` does (its backward is the all-reduce of the cotangent), so
    the gradient reaches every rank's x.  Returns (mean, var, count),
    the count a 0-d fp32 device tensor (ranks may hold different
    counts).  Without a group it is the identity."""
    if process_group is None:
        return mean, var, count
    c = mean.shape[0]
    n = torch.full((1,), float(count), dtype=torch.float32,
                   device=mean.device) if not isinstance(
                       count, torch.Tensor) else count.float().reshape(1)
    packed = torch.cat([n * mean, n * (var + mean * mean), n])
    tot = _AllReduceSum.apply(packed, process_group)
    tn = tot[2 * c]
    tmean = tot[:c] / tn
    tsq = tot[c:2 * c] / tn
    return tmean, torch.clamp_min(tsq - tmean * tmean, 0.0), tn
