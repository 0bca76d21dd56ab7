"""apex_tpu_torch.mlp — the fused MLP (counterpart of apex_tpu/mlp.py,
≡ apex.mlp): the ops layer's names under the reference's."""

from apex_tpu_torch.ops.mlp import MLP, mlp_forward  # noqa: F401

__all__ = ["MLP", "mlp_forward"]
