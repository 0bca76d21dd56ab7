"""ResNet (18/34/50/101/152), NHWC (counterpart of
apex_tpu/models/resnet.py, itself ≡ torchvision's resnet50 as apex's
examples/imagenet/main_amp.py drives it, with the block structure of
apex.contrib.bottleneck).

Functional over nested parameter and state dicts, as the JAX package is:
`ResNet.init(seed)` → (params, state) and `ResNet.apply(params, state,
x, training)` → (logits, new_state), the state holding the batch norms'
running statistics.

Layout.  Activations are NHWC tensors, the JAX package's layout: their
NCHW views (`permute(0, 3, 1, 2)`) are `torch.channels_last`, which is
what cuDNN's convolutions take and give back, and the (rows, C) view the
batch-norm statistics read is free.  Conv weights are stored OHWI (the
JAX package stores HWIO): their OIHW views are channels_last too, and
`params_from_jax` transposes HWIO to OHWI.  Convs and the final matmul
are PyTorch's (cuDNN, cuBLAS), as the JAX package leaves them to XLA.

Two places where a straight PyTorch spelling computes another function:

  * SAME padding is asymmetric: `total // 2` low and the rest high, so
    the 7×7/s2 stem at 224 pads (2, 3) and every 3×3/s2 conv at an even
    size pads (0, 1).  Torchvision's symmetric `padding=3` / `padding=1`
    would shift every window by a pixel; `conv2d` pads explicitly where
    the two sides differ.
  * ReLU is `torch.maximum(x, 0)`, whose gradient at a tie is ½, as
    JAX's `jnp.maximum` gives; `F.relu` gives 0.  Ties are common: the
    last batch norm of every block starts with scale 0, so at the first
    step a residual branch is exactly 0 and `max(out + shortcut, 0)`
    sits on the previous ReLU's zeros.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.models.gpt import params_from_jax as tree_from_jax
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.pooling import _same_pads, max_pool2d
from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm


def conv2d(x, w, stride=1, padding="SAME"):
    """NHWC conv with OHWI weights and JAX's padding ("SAME" or
    "VALID"), one stride for both dims."""
    kh, kw = w.shape[1], w.shape[2]
    if padding == "SAME":
        ph = _same_pads(x.shape[1], kh, stride)
        pw = _same_pads(x.shape[2], kw, stride)
    elif padding == "VALID":
        ph = pw = (0, 0)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        x = F.pad(x, (0, 0) + pw + ph)
        pad = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def relu(x):
    """max(x, 0) with JAX's gradient at the tie (½), not F.relu's (0)."""
    return torch.maximum(x, x.new_zeros(()))


def space_to_depth_2x2(x):
    """(B, H, W, C) → (B, H/2, W/2, 4C), channel order (u, v, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _stem_s2d_weights(w7):
    """The (cout, 7, 7, cin) OHWI stride-2 stem kernel rewritten exactly
    as a (cout, 4, 4, 4·cin) stride-1 kernel over the 2×2 space-to-depth
    input (≡ the JAX package's `_stem_s2d_weights` in HWIO):
    w'[o, ka, kb, (u, v, c)] = w_pad[o, 2ka+u, 2kb+v, c], w zero-padded
    from 7 to 8 taps.  The TPU's reason for it (a 3-channel stride-2 conv
    maps badly onto its matrix unit) does not hold on the card, whose
    default is the 7×7 stem; the function is the same."""
    cout, k, _, cin = w7.shape
    w_pad = w7.new_zeros((cout, 8, 8, cin))
    w_pad[:, :k, :k] = w7
    w_pad = w_pad.reshape(cout, 4, 2, 4, 2, cin)      # (o, ka, u, kb, v, c)
    return w_pad.permute(0, 1, 3, 2, 4, 5).reshape(cout, 4, 4, 4 * cin)


def _bn_apply(params, state, x, training, eps=1e-5, momentum=0.1):
    y, rm, rv = sync_batch_norm(
        x, params["scale"], params["bias"], state["running_mean"],
        state["running_var"], training=training, momentum=momentum,
        eps=eps)
    return y, {"running_mean": rm, "running_var": rv}


class _Init:
    """Seeded draws on one device: kaiming-normal conv weights
    (≡ torchvision's init, as the JAX package draws them), batch norms
    at scale 1, bias 0, running mean 0, variance 1."""

    def __init__(self, seed, device):
        self.dev = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def conv(self, kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cin))
        return torch.randn((cout, kh, kw, cin), generator=self.gen,
                           device=self.dev) * std

    def bn(self, c):
        return ({"scale": torch.ones(c, device=self.dev),
                 "bias": torch.zeros(c, device=self.dev)},
                {"running_mean": torch.zeros(c, device=self.dev),
                 "running_var": torch.ones(c, device=self.dev)})


class Bottleneck:
    """1×1 → 3×3 → 1×1 with residual (≡ the JAX package's `Bottleneck`);
    the stride sits on the 3×3."""

    expansion = 4

    def __init__(self, cin, width, stride=1, downsample=False):
        self.cin = cin
        self.width = width
        self.stride = stride
        self.downsample = downsample
        self.cout = width * self.expansion

    def init(self, draw: _Init):
        params, state = {}, {}
        params["conv1"] = draw.conv(1, 1, self.cin, self.width)
        params["bn1"], state["bn1"] = draw.bn(self.width)
        params["conv2"] = draw.conv(3, 3, self.width, self.width)
        params["bn2"], state["bn2"] = draw.bn(self.width)
        params["conv3"] = draw.conv(1, 1, self.width, self.cout)
        params["bn3"], state["bn3"] = draw.bn(self.cout)
        # zero-init last BN scale ≡ torchvision zero_init_residual
        params["bn3"]["scale"].zero_()
        if self.downsample:
            params["conv_ds"] = draw.conv(1, 1, self.cin, self.cout)
            params["bn_ds"], state["bn_ds"] = draw.bn(self.cout)
        return params, state

    def apply(self, params, state, x, training):
        new_state = {}
        out = conv2d(x, params["conv1"])
        out, new_state["bn1"] = _bn_apply(params["bn1"], state["bn1"], out,
                                          training)
        out = conv2d(relu(out), params["conv2"], stride=self.stride)
        out, new_state["bn2"] = _bn_apply(params["bn2"], state["bn2"], out,
                                          training)
        out = conv2d(relu(out), params["conv3"])
        out, new_state["bn3"] = _bn_apply(params["bn3"], state["bn3"], out,
                                          training)
        if self.downsample:
            sc = conv2d(x, params["conv_ds"], stride=self.stride)
            sc, new_state["bn_ds"] = _bn_apply(params["bn_ds"],
                                               state["bn_ds"], sc, training)
        else:
            sc = x
        return relu(out + sc), new_state


class BasicBlock:
    """3×3 → 3×3 with residual (≡ the JAX package's `BasicBlock`)."""

    expansion = 1

    def __init__(self, cin, width, stride=1, downsample=False):
        self.cin = cin
        self.width = width
        self.stride = stride
        self.downsample = downsample
        self.cout = width

    def init(self, draw: _Init):
        params, state = {}, {}
        params["conv1"] = draw.conv(3, 3, self.cin, self.width)
        params["bn1"], state["bn1"] = draw.bn(self.width)
        params["conv2"] = draw.conv(3, 3, self.width, self.width)
        params["bn2"], state["bn2"] = draw.bn(self.width)
        params["bn2"]["scale"].zero_()
        if self.downsample:
            params["conv_ds"] = draw.conv(1, 1, self.cin, self.cout)
            params["bn_ds"], state["bn_ds"] = draw.bn(self.cout)
        return params, state

    def apply(self, params, state, x, training):
        new_state = {}
        out = conv2d(x, params["conv1"], stride=self.stride)
        out, new_state["bn1"] = _bn_apply(params["bn1"], state["bn1"], out,
                                          training)
        out = conv2d(relu(out), params["conv2"])
        out, new_state["bn2"] = _bn_apply(params["bn2"], state["bn2"], out,
                                          training)
        if self.downsample:
            sc = conv2d(x, params["conv_ds"], stride=self.stride)
            sc, new_state["bn_ds"] = _bn_apply(params["bn_ds"],
                                               state["bn_ds"], sc, training)
        else:
            sc = x
        return relu(out + sc), new_state


_CONFIGS = {
    "resnet10": (BasicBlock, (1, 1, 1, 1)),  # test stand-in
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


class ResNet:
    """≡ the JAX package's `ResNet` at one device.  `stem=
    "space_to_depth"` computes the same function as the default 7×7/s2
    stem through a 2×2 space-to-depth input and a 4×4/s1 conv; the
    params stay (64, 7, 7, 3) either way.  `small_input` is the CIFAR
    stand-in: a 3×3/s1 stem and no max pool."""

    def __init__(self, arch: str = "resnet50", num_classes: int = 1000,
                 small_input: bool = False, stem: str = "conv7"):
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        if stem == "space_to_depth" and small_input:
            raise ValueError(
                "stem='space_to_depth' rewrites the 7x7/s2 ImageNet "
                "stem; the small_input (CIFAR) 3x3/s1 stem has no "
                "stride to fold — use the default stem")
        block_cls, layers = _CONFIGS[arch]
        self.arch = arch
        self.num_classes = num_classes
        self.small_input = small_input
        self.stem = stem
        self.blocks = []
        cin = 64
        for stage, n in enumerate(layers):
            width = 64 * (2 ** stage)
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                downsample = (i == 0 and (stride != 1 or
                                          cin != width * block_cls.expansion))
                blk = block_cls(cin, width, stride, downsample)
                self.blocks.append(blk)
                cin = blk.cout
        self.feat_dim = cin

    def init(self, seed: int = 0, device=None):
        """(params, state) drawn from a `torch.Generator` seeded with
        `seed` on `device` (the card unless the caller asks for the CPU).
        The two frameworks draw different numbers from one seed; tests
        that need both packages on one set of weights convert the JAX
        trees with `params_from_jax`."""
        draw = _Init(seed, resolve_device(device))
        params, state = {}, {}
        stem_k = 3 if self.small_input else 7
        params["conv_stem"] = draw.conv(stem_k, stem_k, 3, 64)
        params["bn_stem"], state["bn_stem"] = draw.bn(64)
        for i, blk in enumerate(self.blocks):
            params[f"block{i}"], state[f"block{i}"] = blk.init(draw)
        params["fc_w"] = torch.randn(
            (self.feat_dim, self.num_classes), generator=draw.gen,
            device=draw.dev) * 0.01
        params["fc_b"] = torch.zeros(self.num_classes, device=draw.dev)
        return params, state

    def apply(self, params, state, x, training: bool = True):
        """Logits (B, num_classes) and the new state for an NHWC batch x
        (B, H, W, 3), in the params' dtype."""
        new_state = {}
        if self.stem == "space_to_depth" and not self.small_input:
            if x.shape[1] % 2 or x.shape[2] % 2:
                raise ValueError(
                    f"stem='space_to_depth' needs even spatial dims, got "
                    f"{x.shape[1]}x{x.shape[2]} — pad the input or use "
                    "the default stem (same function)")
            h = conv2d(space_to_depth_2x2(x),
                       _stem_s2d_weights(params["conv_stem"]), stride=1)
        else:
            h = conv2d(x, params["conv_stem"],
                       stride=1 if self.small_input else 2)
        h, new_state["bn_stem"] = _bn_apply(params["bn_stem"],
                                            state["bn_stem"], h, training)
        h = relu(h)
        if not self.small_input:
            h = max_pool2d(h, (3, 3), (2, 2), "SAME")
        for i, blk in enumerate(self.blocks):
            h, new_state[f"block{i}"] = blk.apply(
                params[f"block{i}"], state[f"block{i}"], h, training)
        h = torch.mean(h, dim=(1, 2))       # global average pool
        logits = torch.matmul(h, params["fc_w"]) + params["fc_b"]
        return logits, new_state


def resnet50(**kw):
    return ResNet("resnet50", **kw)


def resnet18(**kw):
    return ResNet("resnet18", **kw)


def params_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                    device=None, dtype: Optional[torch.dtype] = None):
    """The JAX package's ResNet (params, state) trees, given as nested
    dicts of numpy arrays, as the port's on `device`: the same keys, conv
    weights (every 4-d leaf) transposed from HWIO to OHWI, everything
    else as it is (`models.gpt.params_from_jax` converts the leaves).
    `dtype` casts every leaf; None keeps each array's own float type."""
    def ohwi(tree):
        return {k: ohwi(v) if isinstance(v, dict) else
                (v.permute(3, 0, 1, 2).contiguous() if v.ndim == 4 else v)
                for k, v in tree.items()}

    return (ohwi(tree_from_jax(params, device, dtype)),
            tree_from_jax(state, device, dtype))
