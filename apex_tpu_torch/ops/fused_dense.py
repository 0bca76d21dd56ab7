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
shape and the operands' alignment before the launch: "wgmma" (Hopper's
wgmma fed by TMA: bf16 / fp16 with K and N multiples of 8 and 16-byte
aligned x and w, what a TMA tensor map can address), "mma" (mma.sync:
the other 16-bit shapes, such as apex's MLP's last layer, N = 1) or
"fma" (fp32, in full fp32).  A route whose kernel fails raises; none
stands in for another.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from apex_tpu_torch.ops._common import check_kernel_device, resolve_device

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACT_CODES = {None: 0, "none": 0, "relu": 1, "gelu": 2, "sigmoid": 3}
_ROUTE_CODES = {"fma": 0, "mma": 1, "wgmma": 2}
_LIB = None


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

def _lib():
    global _LIB
    if _LIB is None:
        from apex_tpu_torch import csrc
        lib = csrc.load("fused_dense")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.apex_fused_dense_fwd.restype = i32
        lib.apex_fused_dense_fwd.argtypes = [i32, i32, i32, vp, vp, vp, vp,
                                             i32, i32, i32, vp]
        _LIB = lib
    return _LIB


def gemm_route(dtype, m, n, k, x_ptr, w_ptr):
    """The fused dense kernel that computes x (m, k) · w (k, n) in `dtype`
    with x at address `x_ptr` and w at `w_ptr`: "wgmma" where a TMA tensor
    map can address both operands (bf16 / fp16, k > 0, k and n multiples
    of 8 so every row stride is a multiple of 16 bytes, both bases 16-byte
    aligned), "mma" for the other 16-bit shapes, "fma" for fp32."""
    if dtype == torch.float32:
        return "fma"
    if dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"fused dense kernels take fp32/bf16/fp16, got "
                        f"{dtype}")
    if (k > 0 and k % 8 == 0 and n % 8 == 0 and x_ptr % 16 == 0
            and w_ptr % 16 == 0):
        return "wgmma"
    return "mma"


def _launch(route, x2, w, b, y, activation):
    """Launch the kernel of `route` on the current stream: y = act(x2 · w
    + b) into the preallocated y.  Counts the launch in
    `linear_bias_cuda.launches` and its route's
    `linear_bias_cuda.route_launches`."""
    tensors = [t for t in (x2, w, b, y) if t is not None]
    if not all(t.is_cuda for t in tensors) or len(
            {t.device for t in tensors}) != 1:
        raise ValueError("fused dense kernel inputs must lie on one card")
    (m, k), n = x2.shape, w.shape[1]
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    from apex_tpu_torch.csrc import TENSOR_MAP_ERROR

    err = _lib().apex_fused_dense_fwd(
        _ROUTE_CODES[route], _DTYPE_CODES[x2.dtype], _ACT_CODES[activation],
        x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), m, n, k, stream)
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"fused dense kernel ({route}): "
                           f"cuTensorMapEncodeTiled refused a TMA tensor "
                           f"map, CUresult "
                           f"{err - TENSOR_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"fused dense kernel ({route}) launch failed: "
                           f"CUDA error {err}")
    linear_bias_cuda.launches += 1
    linear_bias_cuda.route_launches[route] += 1


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
