"""NHWC max pooling with the JAX package's padding (counterpart of
apex_tpu/ops/pooling.py).

The JAX package computes the pool with `lax.reduce_window` outside any
Pallas kernel, and leaves its gradient to XLA; here the forward and its
gradient are PyTorch's `F.max_pool2d`.
What must match is the window placement and the tie rule:

  * "SAME" pads `total // 2` low and the rest high (`_same_pads`), with
    −inf: the 3×3/s2 pool at an even size pads (0, 1).  `F.max_pool2d`'s
    own `padding` is symmetric and would put every window one pixel off,
    so the pad is explicit and the pool runs unpadded.
  * A window's gradient goes to its first maximum in row-major order,
    as XLA's SelectAndScatter (GE select) and `F.max_pool2d` both route
    it: the pool follows a ReLU, so its windows hold tied zeros.

`routed_backward=True` is the JAX package's TPU workaround for a slow
SelectAndScatter (a dense parity-routed transpose, off by default); it
is not ported.
"""

from __future__ import annotations

import torch.nn.functional as F


def _same_pads(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def max_pool2d(x, window=(3, 3), strides=(2, 2), padding="SAME",
               routed_backward=False):
    """NHWC max pool (≡ the JAX package's `max_pool2d`): x (B, H, W, C)
    → (B, OH, OW, C), "SAME" or "VALID" padding."""
    if routed_backward:
        raise NotImplementedError(
            "routed_backward is the JAX package's TPU-only workaround for "
            "SelectAndScatter (apex_tpu/ops/pooling.py); it is not ported")
    if padding == "SAME":
        ph = _same_pads(x.shape[1], window[0], strides[0])
        pw = _same_pads(x.shape[2], window[1], strides[1])
        if any(ph + pw):
            x = F.pad(x, (0, 0) + pw + ph, value=-float("inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    # NCHW view of the NHWC tensor: channels_last memory, which the
    # pool keeps
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=tuple(window),
                     stride=tuple(strides))
    return y.permute(0, 2, 3, 1)
