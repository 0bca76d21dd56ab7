"""Sequence-parallel-aware LayerNorm (counterpart of
apex_tpu/transformer/layers/layer_norm.py:21-39, itself ≡
apex/transformer/layers/layer_norm.py:26-74).

Under sequence parallelism each tp rank normalizes its own slice of the
sequence with the replicated weight and bias, so their gradients are
partial sums that must be summed over tp.  The reference tags the params
(`sequence_parallel_enabled`) for an all-reduce by the trainer; here, as
in the JAX package, the params pass through copy_to (identity forward,
all-reduce backward), which puts the sum into the autograd graph: both
through `copy_to_tensor_model_parallel_region_many`, one all-reduce.
"""

from __future__ import annotations

from apex_tpu_torch.ops.layer_norm import FusedLayerNorm, fused_layer_norm
from apex_tpu_torch.parallel.collectives import (
    copy_to_tensor_model_parallel_region_many)
from apex_tpu_torch.parallel.mesh import TP_AXIS


class LayerNorm(FusedLayerNorm):
    """≡ apex.transformer.layers.LayerNorm: `FusedLayerNorm` with the
    sequence_parallel_enabled contract (an nn.Module, as the port's
    `FusedLayerNorm` is: `forward(x)` with the module's parameters where
    the JAX package's functional module has `apply(params, x)`)."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 sequence_parallel_enabled: bool = False,
                 axis_name: str = TP_AXIS, *, device=None, dtype=None):
        kw = {} if dtype is None else {"dtype": dtype}
        super().__init__(normalized_shape, eps, elementwise_affine,
                         device=device, **kw)
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.axis_name = axis_name

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.sequence_parallel_enabled and w is not None:
            w, b = copy_to_tensor_model_parallel_region_many(
                (w, b), self.axis_name)
        return fused_layer_norm(x, w, b, self.eps)
