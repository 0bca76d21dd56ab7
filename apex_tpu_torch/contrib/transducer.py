"""RNN-T transducer joint and loss (counterpart of
apex_tpu/contrib/transducer.py, itself ≡ apex.contrib.transducer's
TransducerJoint and TransducerLoss, apex/contrib/transducer/
transducer.py:5,68).

The joint is a broadcast add (+ ReLU, + dropout).  The loss is the alpha
recursion of the forward-backward algorithm over (T, U + 1), in fp32
(fp64 inputs stay fp64):

    alpha[0, u] = sum_{j < u} lbl[0, j]
    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + lbl[t, u-1])

The JAX package runs a `lax.scan` over T and an associative scan along U
within each row; here the T loop is a Python loop (a scan becomes a
loop), each step vectorised over the batch and U.  Within a row, with A
the time term and c[u] = sum_{j < u} lbl[t, j], the recurrence has the
closed form alpha[t, u] = c[u] + logcumsumexp(A - c)[u].  Label positions
past y_len (impossible emissions, -1e30 in the JAX package) are summed
as 0 into c and their alphas set to -1e30: no valid position (u <=
y_len) reads them, since the recurrence only runs from u - 1 to u and
from t - 1 to t, and nothing of -1e30's size enters a difference, so
neither the loss nor its gradient (autograd's) can turn to NaN.  All of
it is PyTorch's own operators, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import _common

_NEG = -1e30


class TransducerJoint:
    """≡ TransducerJoint (transducer.py:5-66): h = f[:, :, None] +
    g[:, None] with optional ReLU and dropout; packed output raises, as
    in the JAX package."""

    def __init__(self, pack_output=False, relu=False, dropout=0.0):
        if pack_output:
            raise NotImplementedError(
                "packed output is not implemented; use the padded layout")
        self.relu = relu
        self.dropout = dropout

    def __call__(self, f, g, f_len=None, g_len=None, dropout_key=None,
                 is_training=True):
        h = f[:, :, None, :] + g[:, None, :, :]
        if self.relu:
            h = torch.maximum(h, h.new_zeros(()))
        if self.dropout and is_training and dropout_key is not None:
            h = _common.dropout(dropout_key, self.dropout, h)
        return h


def transducer_loss(log_probs, labels, f_len, y_len, blank_idx: int = 0):
    """RNN-T loss ≡ TransducerLoss (the JAX package's `transducer_loss`).

    log_probs: (B, T, U + 1, V) log-softmax over the vocabulary; labels:
    (B, U) int; f_len: (B,) valid frames; y_len: (B,) valid labels.
    Returns the per-sample negative log likelihood (B,), fp32 (fp64 for
    fp64 log-probs)."""
    B, T, U1, _ = log_probs.shape
    U = U1 - 1
    dev = log_probs.device
    ft = torch.promote_types(log_probs.dtype, torch.float32)
    blank = log_probs[..., blank_idx].to(ft)                  # (B, T, U+1)
    idx = labels.long()[:, None, :, None].expand(B, T, U, 1)
    lbl = torch.gather(log_probs[:, :, :U, :], 3, idx)[..., 0].to(ft)
    f_len, y_len = f_len.to(dev).long(), y_len.to(dev).long()
    lbl = torch.where(
        torch.arange(U, device=dev)[None, None, :] < y_len[:, None, None],
        lbl, 0.0)
    live = torch.arange(U1, device=dev)[None, :] <= y_len[:, None]
    c = torch.cat([lbl.new_zeros(B, T, 1), torch.cumsum(lbl, dim=-1)], -1)
    alpha = torch.where(live, c[:, 0], _NEG)
    alphas = [alpha]
    for t in range(1, T):
        a = alpha + blank[:, t - 1]
        ct = c[:, t]
        alpha = torch.where(live, ct + torch.logcumsumexp(a - ct, dim=-1),
                            _NEG)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)                       # (B, T, U+1)
    t_last = (f_len - 1).clamp_min(0)
    rows = torch.arange(B, device=dev)
    return -(alphas[rows, t_last, y_len] + blank[rows, t_last, y_len])


class TransducerLoss:
    """Module facade ≡ TransducerLoss (transducer.py:68); packed input
    raises, as in the JAX package."""

    def __init__(self, packed_input=False):
        if packed_input:
            raise NotImplementedError("packed input is not implemented; "
                                      "use the padded layout")

    def __call__(self, x, label, f_len, y_len, blank_idx=0):
        return transducer_loss(x, label, f_len, y_len, blank_idx)
