"""Blockwise flash attention, forward and backward (counterpart of
apex_tpu/ops/flash_attention.py).

Layout (batch, heads, seq, head_dim), as in the JAX package.  Causal
attention is top-left aligned: query i sees key j iff j <= i.

Two implementations live here:

  * `attention_reference` — the plain PyTorch version: fp32 scores,
    masked scores set to `_NEG_INF` (-1e30), softmax, P.V in fp32.  It
    runs for CPU tensors (autograd gives its gradient), and
    `chip_smoke.py` holds the kernels against it.
  * the CUDA C++ kernels in `apex_tpu_torch/csrc/flash_attention.cu`
    (the ports of `_fwd_kernel` and `_bwd_fused_kernel`), launched by
    `flash_fwd_cuda` / `flash_bwd_cuda` inside `_FlashFn`, a
    `torch.autograd.Function` that saves o and the fp32 lse (b, h, sq).
    Its source note says what bounds them and how.

On CUDA the kernels take the surface the training steps use: causal or
not, segment ids or not (BERT's padding mask), bf16, head_dim 64 or 128,
no bias, no dropout.  Everything else raises NotImplementedError on
CUDA; on the CPU the plain version serves all of it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from apex_tpu_torch.ops._common import check_kernel_device

_NEG_INF = -1e30

_KERNEL_DTYPES = (torch.bfloat16,)
_KERNEL_HEAD_DIMS = (64, 128)


# --------------------------- plain PyTorch version ---------------------------

def attention_reference(q, k, v, *, causal=False, softmax_scale=None,
                        bias=None, q_segment_ids=None, kv_segment_ids=None,
                        dropout_rate=0.0, dropout_key=None):
    """Plain softmax attention with fp32 scores (the op sequence of the
    JAX package's `attention_reference`).  Dropout masks the
    post-softmax weights with a bernoulli draw from `dropout_key`, a
    `torch.Generator` (another stream than any kernel's, the same
    distribution)."""
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, None, :, None]
               != kv_segment_ids[:, None, None, :])
        s = s.masked_fill(seg, _NEG_INF)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).triu(1)
        s = s.masked_fill(mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = torch.rand(p.shape, generator=dropout_key,
                          device=p.device) >= dropout_rate
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ------------------------------- CUDA kernels -------------------------------

_LIB = None


def _bind(lib):
    """Declare the C interface of a loaded flash_attention library."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64, i64p = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
    seg = [vp, vp, i64, i64]           # q_seg, kv_seg and their batch strides
    lib.apex_flash_attn_fwd.restype = i32
    lib.apex_flash_attn_fwd.argtypes = [
        i32, vp, vp, vp, vp, vp, i64p, i32, i32, i32, i32, f32, i32,
        *seg, vp]
    lib.apex_flash_attn_bwd.restype = i32
    lib.apex_flash_attn_bwd.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64p, i32, i32, i32, i32,
        f32, i32, *seg, vp]
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from apex_tpu_torch import csrc
        _LIB = _bind(csrc.load("flash_attention"))
    return _LIB


def _kernel_operand(t):
    """`t` as the kernels read it: bf16, last dim contiguous, every row
    16-byte aligned (base and strides).  A view that is not gets one
    contiguous copy."""
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % 8 for s in t.stride()[:3])):
        t = t.contiguous()
    return t


def _check_kernel_inputs(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes (batch, heads, seq, "
                         "head_dim) tensors")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not agree")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash attention kernel takes bfloat16 q/k/v, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"flash attention kernel takes head_dim "
                                  f"in {_KERNEL_HEAD_DIMS}, got {d}")
    if sq == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs at least one query and "
                         "one key")
    if b * h > 65535:
        raise ValueError(f"flash attention kernel grid holds at most "
                         f"65535 batch*heads, got {b * h}")


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _seg_args(q_seg, kv_seg, b, sq, sk):
    """The C interface's [q_seg, kv_seg, q_seg_sb, kv_seg_sb] (int32 ids
    contiguous along the sequence, a copy only where they are not; or
    nulls) and the id tensors they point into.  The ids are never read
    on the host."""
    if q_seg is None and kv_seg is None:
        return [None, None, 0, 0], ()
    if q_seg is None or kv_seg is None:
        raise ValueError("q_seg and kv_seg go together")
    out = []
    for name, t, s in (("q_seg", q_seg, sq), ("kv_seg", kv_seg, sk)):
        if tuple(t.shape) != (b, s):
            raise ValueError(f"{name} must be ({b}, {s}), got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.int32 or t.stride(1) != 1:
            t = t.to(torch.int32).contiguous()
        out.append(t)
    return [out[0].data_ptr(), out[1].data_ptr(), out[0].stride(0),
            out[1].stride(0)], out


def flash_fwd_cuda(q, k, v, scale, causal, q_seg=None, kv_seg=None):
    """Launch the forward kernel on the current stream; `q_seg` (b, sq)
    and `kv_seg` (b, sk) are optional integer segment ids (both or
    neither).  Returns (o (b, h, sq, d) bf16, lse (b, h, sq) fp32).
    `flash_fwd_cuda.launches` counts launches."""
    _check_kernel_inputs(q, k, v)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    seg, _keep = _seg_args(q_seg, kv_seg, b, sq, sk)
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().apex_flash_attn_fwd(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _strides(q, k, v), b, h, sq, sk, float(scale),
        int(bool(causal)), *seg, stream)
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {err}")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_bwd_cuda(q, k, v, do, lse, delta, scale, causal, q_seg=None,
                   kv_seg=None):
    """Launch the backward kernel on the current stream: dq, dk, dv from
    q, k, v, the output gradient `do`, the forward's fp32 `lse` and
    `delta = sum(do * o, -1)` in fp32, with the forward's segment ids.
    dq is summed across key blocks in an fp32 scratch buffer and cast
    once.  `flash_bwd_cuda.launches` counts launches."""
    _check_kernel_inputs(q, k, v)
    q, k, v, do = (_kernel_operand(t) for t in (q, k, v, do))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    seg, _keep = _seg_args(q_seg, kv_seg, b, sq, sk)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 "
                             f"{(b, h, sq)}, got {tuple(t.shape)} {t.dtype}")
    dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32,
                         device=q.device)
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().apex_flash_attn_bwd(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, do), b, h, sq, sk, float(scale),
        int(bool(causal)), *seg, stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {err}")
    flash_bwd_cuda.launches += 1
    return dq_acc.to(q.dtype), dk, dv


flash_bwd_cuda.launches = 0


class _FlashFn(torch.autograd.Function):
    """The kernels as one differentiable op: forward saves o and the fp32
    lse; backward forms delta = sum(do * o) in fp32 (as `_bwd_impl`
    does) and runs the single-pass backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_seg, kv_seg):
        o, lse = flash_fwd_cuda(q, k, v, scale, causal, q_seg, kv_seg)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        delta = torch.sum(do.float() * o.float(), dim=-1)
        dq, dk, dv = flash_bwd_cuda(q, k, v, do, lse, delta, ctx.scale,
                                    ctx.causal, q_seg, kv_seg)
        return dq, dk, dv, None, None, None, None


# --------------------------------- public API -------------------------------

def flash_attention(q, k, v, *, causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    bias=None,
                    segment_ids=None,
                    q_segment_ids=None,
                    kv_segment_ids=None,
                    dropout_rate: float = 0.0,
                    dropout_key=None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    heads_per_step: Optional[int] = None,
                    bias_grad: bool = True):
    """Flash attention over (batch, heads, seq, head_dim) ≡ the JAX
    package's `flash_attention` (same arguments and checks).  CPU tensors
    run the plain version (which takes every argument; `dropout_key` is
    a `torch.Generator` there); CUDA tensors run the kernels or raise:
    bias and dropout raise NotImplementedError on CUDA.  Segment ids go
    to the segment-masked kernels as they are, never read on the host;
    a masked score is -1e30, so a query row with every key masked gets
    uniform weights over the keys, as the plain version gives it.

    block_q / block_k: the TPU kernel's tile knobs; the CUDA kernels
    tile by 64 x 64 and do not take them yet.  heads_per_step: accepted
    and ignored — on Hopper head packing is a tile-shape choice inside
    these kernels, a tuner axis still to come (ROADMAP Queue 2 item 6).
    """
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if segment_ids is not None:
        if q_segment_ids is not None or kv_segment_ids is not None:
            raise ValueError(
                "pass either segment_ids or q_/kv_segment_ids, not both")
        q_segment_ids = kv_segment_ids = segment_ids
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    b, h = q.shape[0], q.shape[1]
    sq, sk = q.shape[2], k.shape[2]
    if bias is not None:
        if (bias.ndim != 4 or bias.shape[0] not in (1, b)
                or bias.shape[1] not in (1, h)
                or bias.shape[2] not in (1, sq)
                or bias.shape[3] not in (1, sk)):
            raise ValueError(
                f"bias shape {tuple(bias.shape)} not broadcastable to "
                f"({b}|1, {h}|1, {sq}|1, {sk}|1)")
    if q_segment_ids is not None and (
            tuple(q_segment_ids.shape) != (b, sq)
            or tuple(kv_segment_ids.shape) != (b, sk)):
        raise ValueError(
            f"segment id shapes {tuple(q_segment_ids.shape)}/"
            f"{tuple(kv_segment_ids.shape)} != ({b}, {sq})/({b}, {sk})")
    extras = [t for t in (bias, q_segment_ids, kv_segment_ids)
              if t is not None]
    if not check_kernel_device(q, k, v, *extras):
        if bias is not None and not bias_grad:
            bias = bias.detach()
        return attention_reference(
            q, k, v, causal=causal, softmax_scale=scale, bias=bias,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            dropout_rate=dropout_rate, dropout_key=dropout_key)
    unsupported = [name for name, on in (
        ("bias", bias is not None),
        ("dropout", dropout_rate > 0.0)) if on]
    if unsupported:
        raise NotImplementedError(
            f"flash attention on CUDA does not take {', '.join(unsupported)} "
            "yet (the training steps' surface is causal or not, segment "
            "ids or not, no bias, no dropout)")
    return _FlashFn.apply(q, k, v, float(scale), bool(causal),
                          q_segment_ids, kv_segment_ids)
