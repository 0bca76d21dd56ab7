"""Fused dense: matmul + bias + activation (counterpart of
apex_tpu/ops/fused_dense.py, itself ≡ apex's fused_dense_cuda and
fused_weight_gradient_mlp_cuda extensions and apex.fused_dense's
FusedDense / FusedDenseGeluDense).

Weights are in the JAX package's layout, w (in, out), so
`params_from_jax` is a plain copy and y = act(x · w + b).  Two
implementations of the forward:

  * `linear_bias_reference` — the plain PyTorch version: the product of
    the operands upcast to fp32 (exact products, fp32 sums: the JAX
    package's `preferred_element_type=float32`), the bias added in fp32,
    the activation, one rounding to x's dtype.  CPU tensors run it
    (autograd gives its gradient); `chip_smoke.py` holds the kernel
    against it.
  * the CUDA C++ kernels in `apex_tpu_torch/csrc/fused_dense.cu` (the
    port of `_matmul_kernel`), launched by `linear_bias_cuda` inside
    `_FusedLinearFn`, the counterpart of the JAX package's custom_vjp:
    where a gradient is needed and there is an activation, the forward
    launches the kernel without it and keeps the pre-activation for the
    backward; otherwise the activation is fused into the kernel's
    epilogue.  The backward's dgrad and wgrad are plain `torch.matmul`s
    (the JAX package leaves them to XLA) and db is the fp32 sum of the
    grads.  Its source note says what bounds the kernel and how.

Activations: relu, gelu (the tanh approximation, as the JAX package's
`jax.nn.gelu(approximate=True)`), sigmoid, none.  On CUDA the kernels
take fp32, bf16 and fp16 operands of one dtype with any M, N and K;
anything else raises.  `gemm_route` picks the kernel from the dtype, the
shape and the operands' alignment before the launch: "gemv" (N ≤ 8 in
any dtype: a warp a row of x, such as apex's MLP's last layer, N = 1),
"wgmma" (Hopper's wgmma fed by TMA: bf16 / fp16 with K and N multiples
of 8 and 16-byte aligned x and w, what a TMA tensor map can address),
"mma" (mma.sync: the other 16-bit shapes) or "fma" (fp32, in full fp32,
its K split among the blocks of a cluster by `f32_plan`).  A route
whose kernel fails raises; none stands in for another.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from apex_tpu_torch.ops._common import (add_kernel_flops,
                                        check_kernel_device, resolve_device,
                                        sm_count as _sm_count)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACT_CODES = {None: 0, "none": 0, "relu": 1, "gelu": 2, "sigmoid": 3}
_ROUTE_CODES = {"fma": 0, "mma": 1, "wgmma": 2, "gemv": 3}
GEMV_MAX_N = 8                # the widest y the GEMV kernel takes
F32_TILES = ((128, 128), (128, 64))   # the fp32 kernel's blocks of y
F32_SLICE = 16                # the fp32 kernel's depth per pipeline slice
F32_MAX_SPLIT = 8             # blocks a cluster (the portable limit)
# `f32_plan`'s costs, in the time of one 16-deep slice of a 128 x 128
# block (1.6 us on an NVIDIA H100 80GB HBM3 at 700 W), fitted to that
# card's times of the MLP layers by tile and split
# (scripts/port_hopper_ablation.py --gemm32): a slice of each tile (the
# 128 x 64 tile does half the FMAs with the same copies, barrier and
# reads of x); a block's epilogue, per 128 x 128 of y it sums and
# stores; a cluster's reduction, F32_REDUCE[0] + F32_REDUCE[1] × split
F32_TILE_COST = {(128, 128): 1.0, (128, 64): 0.62}
F32_EPILOGUE = 7.8
F32_REDUCE = (1.5, 0.5)
_LIB = None
_CLUSTERS = {}


def _act(y, activation):
    """The activation on fp32 `y` (≡ the JAX package's `_act`)."""
    if activation == "relu":
        return torch.relu(y)
    if activation == "gelu":
        return TF.gelu(y, approximate="tanh")
    if activation == "sigmoid":
        return torch.sigmoid(y)
    if activation in (None, "none"):
        return y
    raise ValueError(f"unknown activation {activation!r}")


# ------------------------------ plain PyTorch -------------------------------

def linear_bias_reference(x, w, b=None, activation=None):
    """act(x · w + b) in plain PyTorch: fp32 product and bias, one
    rounding to x's dtype."""
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return _act(y, activation).to(x.dtype)


# ------------------------------- CUDA kernel --------------------------------

def _bind(lib):
    """`lib` (a build of csrc/fused_dense.cu) with its C entry's types."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.apex_fused_dense_fwd.restype = i32
    lib.apex_fused_dense_fwd.argtypes = [i32, i32, i32, vp, vp, vp, vp,
                                         i32, i32, i32, i32, i32, i32, i32,
                                         vp]
    lib.apex_fused_dense_f32_clusters.restype = i32
    lib.apex_fused_dense_f32_clusters.argtypes = [i32, i32]
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from apex_tpu_torch import csrc
        _LIB = _bind(csrc.load("fused_dense"))
    return _LIB


def f32_clusters(device):
    """{tile: [clusters of s fp32-kernel blocks of that tile the card holds
    at once, s = 1 .. F32_MAX_SPLIT]} (the runtime's cluster occupancy
    query; an H100 SXM holds 132, 66, 39, 30, 22, 17, 15, 15 of either:
    one block an SM, a cluster on SMs of one GPC)."""
    if device not in _CLUSTERS:
        with torch.cuda.device(device):
            got = {tile: [_lib().apex_fused_dense_f32_clusters(tile[1], s)
                          for s in range(1, F32_MAX_SPLIT + 1)]
                   for tile in F32_TILES}
        if min(min(v) for v in got.values()) <= 0:
            raise RuntimeError(f"fused dense fp32 kernel: cluster "
                               f"occupancy query failed: {got}")
        _CLUSTERS[device] = got
    return _CLUSTERS[device]


def gemm_route(dtype, m, n, k, x_ptr, w_ptr):
    """The fused dense kernel that computes x (m, k) · w (k, n) in `dtype`
    with x at address `x_ptr` and w at `w_ptr`: "gemv" for n ≤ 8 in any
    dtype; else "fma" for fp32, "wgmma" where a TMA tensor map can
    address both operands (bf16 / fp16, k > 0, k and n multiples of 8 so
    every row stride is a multiple of 16 bytes, both bases 16-byte
    aligned), "mma" for the other 16-bit shapes."""
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"fused dense kernels take fp32/bf16/fp16, got "
                        f"{dtype}")
    if n <= GEMV_MAX_N:
        return "gemv"
    if dtype == torch.float32:
        return "fma"
    if (k > 0 and k % 8 == 0 and n % 8 == 0 and x_ptr % 16 == 0
            and w_ptr % 16 == 0):
        return "wgmma"
    return "mma"


def f32_plan(m, n, k, sms, clusters=None):
    """The fp32 kernel's plan for y (m, n) = x (m, k) · w (k, n) on a card
    of `sms` SMs that holds `clusters[tile][s - 1]` clusters of s blocks
    of each tile at once (`f32_clusters`; by default sms // s, one block
    an SM): (tile, split, k_split).  Each block computes a tile of y (one
    of F32_TILES); `split` blocks of one cluster share its depth,
    `k_split` (whole F32_SLICE-deep slices) each, block r taking
    [r k_split, (r + 1) k_split) ∩ [0, k), and each sums and stores
    1 / split of the tile.  Of the tiles and the splits 1 to
    F32_MAX_SPLIT that leave no block without a slice, the plan takes the
    one whose busiest SM has the least to do: waves × (slices a block ×
    F32_TILE_COST + its epilogue + the reduction), a wave being as many
    tiles as the card holds clusters; ties go to the larger tile, then
    the smaller split.  apex's MLP layers (batch 1024) on an H100 SXM:
    128 x 128 split 2 at 480 → 1024 and 1024 → 1024, 128 x 64 split 2 at
    1024 → 512 and split 3 at 512 → 256."""
    slices = -(-k // F32_SLICE)
    best = None
    for tile in F32_TILES:
        tiles = -(-m // tile[0]) * -(-n // tile[1])
        for split in range(1, F32_MAX_SPLIT + 1):
            per = -(-slices // split)
            if split > 1 and (split - 1) * per >= slices:
                continue          # a block would have no slice
            held = clusters[tile][split - 1] if clusters else sms // split
            waves = -(-tiles // max(held, 1))
            cost = waves * (
                per * F32_TILE_COST[tile]
                + F32_EPILOGUE * tile[0] * tile[1] / (128 * 128 * split)
                + (F32_REDUCE[0] + F32_REDUCE[1] * split if split > 1
                   else 0))
            if best is None or cost < best[0]:
                best = (cost, tile, split, per * F32_SLICE)
    return best[1:]


def vec_loads(route, el, k, n, x_ptr, w_ptr):
    """Whether the kernel of `route` reads its operands 16 bytes a thread
    (else one element): the fp32 route where k and n are multiples of 4
    and x and w 16-byte aligned (a 16-byte chunk of a row is then all in
    or all out of the tile), the GEMV route where every row of x starts
    16-byte aligned (x aligned, k · `el` bytes a multiple of 16); the
    16-bit routes decide their own loads."""
    if route == "fma":
        return k % 4 == 0 and n % 4 == 0 and x_ptr % 16 == 0 and (
            w_ptr % 16 == 0)
    if route == "gemv":
        return x_ptr % 16 == 0 and k * el % 16 == 0
    return False


@functools.lru_cache(maxsize=4096)
def _f32_plan_on(m, n, k, device):
    """`f32_plan` on `device`'s SMs and clusters, once a shape (the search
    is a Python loop, and the MLP leg is host-bound)."""
    return f32_plan(m, n, k, _sm_count(device), f32_clusters(device))


def _plan(route, x2, w):
    """(tile_n, split, k_split, vec) of the C entry for this call:
    `f32_plan` on the card's SMs and clusters for the fp32 route (its
    tile's width), one block's depth for the others (tile_n 0);
    `vec_loads`."""
    (m, k), n = x2.shape, w.shape[1]
    tile_n, split, k_split = 0, 1, k
    if route == "fma":
        tile, split, k_split = _f32_plan_on(m, n, k, x2.device)
        tile_n = tile[1]
    vec = vec_loads(route, x2.element_size(), k, n, x2.data_ptr(),
                    w.data_ptr())
    return tile_n, split, k_split, vec


def _launch(route, x2, w, b, y, activation):
    """Launch the kernel of `route` on the current stream under `_plan`:
    y = act(x2 · w + b) into the preallocated y.  Counts the launch in
    `linear_bias_cuda.launches` and its route's
    `linear_bias_cuda.route_launches`, and keeps the plan in
    `linear_bias_cuda.last_plan`."""
    tensors = [t for t in (x2, w, b, y) if t is not None]
    if not all(t.is_cuda for t in tensors) or len(
            {t.device for t in tensors}) != 1:
        raise ValueError("fused dense kernel inputs must lie on one card")
    (m, k), n = x2.shape, w.shape[1]
    tile_n, split, k_split, vec = _plan(route, x2, w)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    from apex_tpu_torch.csrc import TENSOR_MAP_ERROR

    err = _lib().apex_fused_dense_fwd(
        _ROUTE_CODES[route], _DTYPE_CODES[x2.dtype], _ACT_CODES[activation],
        x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), m, n, k, tile_n, split, k_split, int(vec), stream)
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"fused dense kernel ({route}): "
                           f"cuTensorMapEncodeTiled refused a TMA tensor "
                           f"map, CUresult "
                           f"{err - TENSOR_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"fused dense kernel ({route}) launch failed: "
                           f"CUDA error {err}")
    add_kernel_flops(2 * m * n * k)
    linear_bias_cuda.launches += 1
    linear_bias_cuda.route_launches[route] += 1
    linear_bias_cuda.last_plan = {"route": route, "tile_n": tile_n,
                                  "split": split, "k_split": k_split,
                                  "vec": vec}


def linear_bias_cuda(x2, w, b, activation):
    """Launch the fused dense kernel that `gemm_route` picks on the
    current stream: y = act(x2 · w + b) for x2 (M, K) and w (K, N) of one
    dtype (fp32, bf16, fp16), both contiguous on one card, b (N,) of any
    float dtype or None.  Returns y (M, N) in x2's dtype.
    `linear_bias_cuda.launches` counts launches and
    `linear_bias_cuda.route_launches` each route's."""
    if x2.ndim != 2 or w.ndim != 2 or x2.shape[1] != w.shape[0]:
        raise ValueError(f"fused dense kernel needs x (M, K) and w (K, N); "
                         f"got {tuple(x2.shape)} and {tuple(w.shape)}")
    if x2.dtype not in _DTYPE_CODES or w.dtype != x2.dtype:
        raise TypeError(f"fused dense kernel takes x and w of one dtype in "
                        f"fp32/bf16/fp16; got {x2.dtype} and {w.dtype}")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused dense kernel needs contiguous x and w")
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    (m, k), n = x2.shape, w.shape[1]
    if b is not None:
        if b.shape != (n,):
            raise ValueError(f"bias {tuple(b.shape)} for {n} columns")
        b = b.to(torch.float32).contiguous()
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0 or n == 0:
        return y
    route = gemm_route(x2.dtype, m, n, k, x2.data_ptr(), w.data_ptr())
    _launch(route, x2, w, b, y, activation)
    return y


linear_bias_cuda.launches = 0
linear_bias_cuda.route_launches = {route: 0 for route in _ROUTE_CODES}
linear_bias_cuda.last_plan = None


def _act_grad(g32, pre, activation):
    """The activation's vector-Jacobian product at the pre-activation
    `pre`, in fp32 (≡ the JAX package's `_fused_linear_bwd`)."""
    if activation == "relu":
        return torch.where(pre > 0, g32, 0.0)
    if activation == "gelu":
        # rounded to the pre-activation's dtype, as the JAX rule's vjp at
        # `pre` returns it
        return torch.ops.aten.gelu_backward(
            g32, pre.float(), approximate="tanh").to(pre.dtype).float()
    if activation == "sigmoid":
        s = torch.sigmoid(pre.float())
        return g32 * s * (1.0 - s)
    return g32


class _FusedLinearFn(torch.autograd.Function):
    """The kernel's forward with the JAX package's custom_vjp backward."""

    @staticmethod
    def forward(ctx, x2, w, b, activation):
        if activation in (None, "none"):
            ctx.save_for_backward(x2, w, b, None)
            ctx.activation = None
            return linear_bias_cuda(x2, w, b, None)
        pre = linear_bias_cuda(x2, w, b, None)
        ctx.save_for_backward(x2, w, b, pre)
        ctx.activation = activation
        return _act(pre.float(), activation).to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w, b, pre = ctx.saved_tensors
        g32 = _act_grad(g.float(), pre, ctx.activation)
        g_cast = g32.to(x2.dtype)
        dx = torch.matmul(g_cast, w.t()) if ctx.needs_input_grad[0] else None
        dw = (torch.matmul(x2.t(), g_cast).to(w.dtype)
              if ctx.needs_input_grad[1] else None)
        db = (g32.sum(0).to(b.dtype)
              if b is not None and ctx.needs_input_grad[2] else None)
        return dx, dw, db, None


def _linear_fused(x2, w, b, activation):
    """The CUDA route of `linear_bias` on a 2-D x: through autograd when a
    gradient is needed, else one launch with the activation fused."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, w, b)):
        return _FusedLinearFn.apply(x2, w, b, activation)
    return linear_bias_cuda(x2, w, b, activation)


# --------------------------------- public API -------------------------------

def linear_bias(x, w, b=None, activation: Optional[str] = None):
    """y = act(x · w + b) with the epilogue fused (≡ the JAX package's
    `linear_bias`, fused_dense_cuda.linear_bias_forward): x (..., K),
    w (K, N), b (N,).  CPU tensors run the plain version; CUDA tensors
    run the kernel or raise."""
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    tensors = [t for t in (x, w, b) if t is not None]
    x2 = x.reshape(-1, x.shape[-1])
    if not check_kernel_device(*tensors):
        y = linear_bias_reference(x2, w, b, activation)
    else:
        y = _linear_fused(x2.contiguous(), w.contiguous(), b, activation)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def linear_gelu_linear(x, w1, b1, w2, b2):
    """(gelu(x · w1 + b1)) · w2 + b2 ≡ the JAX package's
    `linear_gelu_linear` (fused_dense_cuda.linear_gelu_linear_forward):
    two launches of the kernel."""
    return linear_bias(linear_bias(x, w1, b1, "gelu"), w2, b2, None)


def qkv_split_heads(qkv, num_heads, head_dim):
    """Packed-QKV head split: (S, B, 3·nh·d) → three (B, nh, S, d) views.

    The packed tensor is transposed once to (3, B, nh, S, d) and q, k, v
    are its leading-dim slices (`unbind`, whose gradient is one stack),
    as in the JAX package.  The views are not contiguous: the flash
    kernels read them through their strides."""
    s, b = qkv.shape[:2]
    qkv = qkv.reshape(s, b, 3, num_heads, head_dim)
    return qkv.permute(2, 1, 3, 0, 4).unbind(0)


def wgrad_accum(main_grad, x, g):
    """main_grad += xᵀ · g in fp32, IN PLACE (≡ the JAX package's
    `wgrad_accum`, fused_weight_gradient_mlp_cuda.wgrad_gemm_accum_fp32:
    the weight-grad GEMM that accumulates into a persistent fp32
    buffer).  Returns main_grad."""
    x2 = x.reshape(-1, x.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    return main_grad.addmm_(x2.t().float(), g2.float())


def params_from_jax(params, device=None):
    """The JAX package's FusedDense / FusedDenseGeluDense / MLP params (a
    dict of arrays, lists of arrays under "weights"/"biases") as a
    state dict of the port's modules: the same layout, so a plain copy;
    list entries become "name.i" keys and None entries are dropped."""
    out = {}
    for key, val in params.items():
        vals = val if isinstance(val, (list, tuple)) else [val]
        for i, v in enumerate(vals):
            if v is None:
                continue
            name = f"{key}.{i}" if isinstance(val, (list, tuple)) else key
            arr = np.asarray(v)
            t = (torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
                 if arr.dtype.name == "bfloat16"
                 else torch.from_numpy(np.array(arr)))
            out[name] = t.to(device) if device is not None else t
    return out


def _uniform(gen, shape, bound, device, dtype):
    """Uniform in ±bound from the CPU generator `gen`, on `device`."""
    return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1)
            * bound).to(device=device, dtype=dtype)


class FusedDense(nn.Module):
    """≡ apex.fused_dense.FusedDense (the JAX package's `FusedDense`):
    weight (in, out) and bias (out,), uniform in ±1/√in from `seed`, on
    the card unless `device` says otherwise."""

    def __init__(self, in_features, out_features, bias=True, *, seed=0,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(_uniform(
            gen, (in_features, out_features), bound, device, dtype))
        if bias:
            self.bias = nn.Parameter(_uniform(gen, (out_features,), bound,
                                              device, dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return linear_bias(x, self.weight, self.bias, None)


class FusedDenseGeluDense(nn.Module):
    """≡ apex.fused_dense.FusedDenseGeluDense (the JAX package's
    `FusedDenseGeluDense`): gelu(x · weight1 + bias1) · weight2 + bias2,
    two launches of the kernel a forward."""

    def __init__(self, in_features, intermediate_features, out_features,
                 bias=True, *, seed=0, device=None, dtype=torch.float32):
        super().__init__()
        if not bias:
            raise NotImplementedError(
                "FusedDenseGeluDense without bias (the JAX package's init "
                "always makes both biases)")
        device = resolve_device(device)
        i, h, o = in_features, intermediate_features, out_features
        self.sizes = (i, h, o)
        gen = torch.Generator().manual_seed(seed)
        b1, b2 = 1.0 / math.sqrt(i), 1.0 / math.sqrt(h)
        self.weight1 = nn.Parameter(_uniform(gen, (i, h), b1, device, dtype))
        self.bias1 = nn.Parameter(_uniform(gen, (h,), b1, device, dtype))
        self.weight2 = nn.Parameter(_uniform(gen, (h, o), b2, device, dtype))
        self.bias2 = nn.Parameter(_uniform(gen, (o,), b2, device, dtype))

    def forward(self, x):
        return linear_gelu_linear(x, self.weight1, self.bias1, self.weight2,
                                  self.bias2)
