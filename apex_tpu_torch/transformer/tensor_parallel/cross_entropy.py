"""Vocab-parallel cross entropy at tp=1 (counterpart of
apex_tpu/transformer/tensor_parallel/cross_entropy.py).

Per-token loss lse(x) - x[label] from the logits, in fp32 whatever the
logits' dtype; label smoothing as in the JAX package.  At tp=1 the max,
sum-exp and target-logit collectives are identities.

Two backward strategies, as in the JAX package:

* unfused: plain autograd through the fp32 upcast (the max shift is
  detached; it changes nothing but stability).
* fused (`_FusedXent`, a `torch.autograd.Function`): the forward saves
  only the logits in their own dtype and the fp32 log-sum-exp per token;
  the backward rebuilds softmax(x) - q in fp32 and emits
  g * (softmax - q) in the logits' dtype.  With bf16 logits that keeps
  the (S, B, V) fp32 upcast out of the saved activations.

`fused=None` picks fused exactly when the logits are not fp32.
"""

from __future__ import annotations

import torch


def _unfused(logits, labels, smoothing):
    x = logits.float()
    mx = x.detach().max(dim=-1).values
    lse = torch.log(torch.sum(torch.exp(x - mx[..., None]), dim=-1)) + mx
    picked = torch.gather(x, -1, labels[..., None].long())[..., 0]
    loss = lse - picked
    if smoothing > 0:
        mean_log_prob = torch.sum(x, dim=-1) / x.shape[-1] - lse
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_prob
    return loss


def _fused_forward(logits, labels, smoothing):
    x = logits.float()
    mx = torch.max(x, dim=-1).values
    lse = torch.log(torch.sum(torch.exp(x - mx[..., None]), dim=-1)) + mx
    picked = torch.gather(x, -1, labels[..., None].long())[..., 0]
    loss = lse - picked
    if smoothing > 0:
        loss = ((1.0 - smoothing) * loss
                + smoothing * (lse - torch.sum(x, dim=-1) / x.shape[-1]))
    return loss, lse


class _FusedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing):
        loss, lse = _fused_forward(logits, labels, smoothing)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        s = ctx.smoothing
        # softmax(x) - q, built in place in one fp32 (S, B, V) buffer
        d = logits.to(torch.float32, copy=True).sub_(lse[..., None]).exp_()
        d.scatter_add_(-1, labels[..., None].long(),
                       torch.full(labels.shape + (1,), -(1.0 - s),
                                  dtype=d.dtype, device=d.device))
        if s > 0:
            d.sub_(s / logits.shape[-1])
        return d.mul_(g[..., None]).to(logits.dtype), None, None


def vocab_parallel_cross_entropy(logits, labels, smoothing: float = 0.0,
                                 fused=None):
    """Per-token loss from (..., V) logits and (...) integer labels.
    fused: None (auto — fused iff the logits are not fp32), True/False
    to force.  Both paths compute the same fp32 math."""
    if fused is None:
        fused = logits.dtype != torch.float32
    if fused:
        return _FusedXent.apply(logits, labels, float(smoothing))
    return _unfused(logits, labels, smoothing)
