"""Mixed-precision policies — the O0–O3 opt levels (counterpart of
apex_tpu/amp/policy.py).

The JAX package replaces apex's op patching with an explicit `Policy`:
a (param, compute, output) dtype triple applied where the train step
casts, with the reference cast lists kept as the contract of which op
classes run in low precision (`MATMUL_CLASS_OPS`) and which stay fp32
(`FP32_CLASS_OPS`).  The port keeps that design rather than
`torch.autocast`, which casts op by op from its own lists and computes
another function: under O1 the step casts the params and the floating
batch to the compute dtype once, batch norm normalises in fp32 and
returns the input's dtype, and the loss takes fp32 logits.

Trees are nested dicts, lists and tuples of tensors; a cast touches
floating tensors only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

MATMUL_CLASS_OPS = ("conv", "matmul", "dense", "attention", "mlp", "einsum")
FP32_CLASS_OPS = (
    "softmax", "log_softmax", "layer_norm", "batch_norm", "group_norm",
    "cross_entropy", "mse_loss", "l1_loss", "exp", "log", "pow", "sum",
    "cumsum", "var", "std", "norm",
)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _cast_floating(tree, dtype):
    def cast(_, x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    return _map_with_path(cast, tree)


@dataclasses.dataclass(frozen=True)
class Policy:
    """(param, compute, output) dtype triple (≡ the JAX package's
    `Policy`, itself ≡ the Properties of apex.amp.frontend.initialize).
    `keep_norm_fp32` ≡ keep_batchnorm_fp32, `master_weights` ≡
    master_weights, `loss_scale` is "dynamic", None or a float."""

    opt_level: str = "O1"
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32
    keep_norm_fp32: bool = True
    master_weights: bool = False
    loss_scale: Optional[Any] = None

    def cast_to_compute(self, *trees):
        out = tuple(_cast_floating(t, self.compute_dtype) for t in trees)
        return out[0] if len(out) == 1 else out

    def cast_to_param(self, *trees):
        out = tuple(_cast_floating(t, self.param_dtype) for t in trees)
        return out[0] if len(out) == 1 else out

    def cast_to_output(self, *trees):
        out = tuple(_cast_floating(t, self.output_dtype) for t in trees)
        return out[0] if len(out) == 1 else out

    def compute_for(self, op_name: str):
        """Compute dtype for a named op class: the matmul list wins over
        the fp32 list on compound names ("einsum" holds "sum"); under O3
        (keep_norm_fp32=False) fp32-class ops run in the compute dtype
        too."""
        if any(k in op_name for k in MATMUL_CLASS_OPS):
            return self.compute_dtype
        if any(k in op_name for k in FP32_CLASS_OPS):
            return torch.float32 if self.keep_norm_fp32 else self.compute_dtype
        return self.compute_dtype


def get_policy(opt_level: str = "O1", low_dtype=torch.bfloat16,
               **overrides) -> Policy:
    """An O0–O3 preset with keyword overrides (≡ the JAX package's
    `get_policy`; the table of apex/amp/frontend.py).  The low dtype
    defaults to bfloat16; pass torch.float16 for fp16 with dynamic loss
    scaling."""
    f32, low = torch.float32, low_dtype
    presets = {
        "O0": dict(param_dtype=f32, compute_dtype=f32, output_dtype=f32,
                   master_weights=False, loss_scale=1.0),
        "O1": dict(param_dtype=f32, compute_dtype=low, output_dtype=f32,
                   master_weights=False, loss_scale="dynamic"),
        "O2": dict(param_dtype=low, compute_dtype=low, output_dtype=f32,
                   master_weights=True, keep_norm_fp32=True,
                   loss_scale="dynamic"),
        "O3": dict(param_dtype=low, compute_dtype=low, output_dtype=low,
                   master_weights=False, keep_norm_fp32=False,
                   loss_scale=1.0),
    }
    if opt_level not in presets:
        raise ValueError(f"Unexpected optimization level {opt_level}")
    cfg = presets[opt_level]
    cfg.update(overrides)
    return Policy(opt_level=opt_level, **cfg)


# --- fp16_utils equivalents ------------------------------------------------

def convert_network(params, dtype, is_norm_param=None):
    """Cast a param tree to `dtype`, keeping norm-layer params fp32 (≡ the
    JAX package's `convert_network`, itself ≡ apex.fp16_utils.
    convert_network).  `is_norm_param(path)` decides which leaves stay
    fp32; by default keys holding norm/bn/batchstats."""
    if is_norm_param is None:
        def is_norm_param(path):
            p = "/".join(str(k) for k in path).lower()
            return ("norm" in p) or ("bn" in p) or ("batchstats" in p)

    def cast(path, x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        return x.to(torch.float32 if is_norm_param(path) else dtype)

    return _map_with_path(cast, params)


def prep_param_lists(params):
    """(model params, fp32 master copies) ≡ fp16_utils.prep_param_lists."""
    return params, _cast_floating(params, torch.float32)


def model_grads_to_master_grads(model_grads):
    """≡ fp16_utils.model_grads_to_master_grads: the grads in fp32."""
    return _cast_floating(model_grads, torch.float32)


def master_params_to_model_params(master_params, model_params):
    """≡ fp16_utils.master_params_to_model_params: each master leaf cast
    to its model leaf's dtype."""
    def cast(m, p):
        if isinstance(m, Mapping):
            return {k: cast(m[k], p[k]) for k in m}
        if isinstance(m, (list, tuple)):
            return type(m)(cast(a, b) for a, b in zip(m, p))
        return m.to(p.dtype) if isinstance(p, torch.Tensor) else m
    return cast(master_params, model_params)
