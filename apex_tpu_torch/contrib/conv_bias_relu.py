"""Conv + bias (+ mask) (+ ReLU), and the frozen-BN form (counterpart of
apex_tpu/contrib/conv_bias_relu.py, itself ≡
apex.contrib.conv_bias_relu, apex/contrib/conv_bias_relu/
conv_bias_relu.py:12-78).  NHWC activations and OHWI weights over the
port's `models.resnet.conv2d` (cuDNN); the epilogues are PyTorch's own
operators, and ReLU is `models.resnet.relu` (JAX's gradient at 0)."""

from __future__ import annotations

from apex_tpu_torch.models.resnet import conv2d, relu


def _row(t):
    return t.reshape(1, 1, 1, -1)


def conv_bias_relu(x, w, b, stride: int = 1, padding: str = "SAME"):
    """≡ ConvBiasReLU_: relu(conv(x, w) + b)."""
    return relu(conv2d(x, w, stride=stride, padding=padding) + _row(b))


def conv_bias(x, w, b, stride: int = 1, padding: str = "SAME"):
    """≡ ConvBias_: conv(x, w) + b."""
    return conv2d(x, w, stride=stride, padding=padding) + _row(b)


def conv_bias_mask_relu(x, w, b, mask, stride: int = 1,
                        padding: str = "SAME"):
    """≡ ConvBiasMaskReLU_: relu((conv(x, w) + b) * mask)."""
    return relu((conv2d(x, w, stride=stride, padding=padding) + _row(b))
                * mask)


def conv_frozen_scale_bias_relu(x, w, scale, bias, stride: int = 1,
                                padding: str = "SAME"):
    """≡ ConvFrozenScaleBiasReLU_ (the frozen-BN inference form):
    relu(conv(x, w) * scale + bias)."""
    return relu(conv2d(x, w, stride=stride, padding=padding) * _row(scale)
                + _row(bias))
