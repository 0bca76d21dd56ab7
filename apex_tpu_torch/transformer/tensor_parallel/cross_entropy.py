"""Vocab-parallel cross entropy (counterpart of
apex_tpu/transformer/tensor_parallel/cross_entropy.py:43-163).

Per-token loss lse(x) - x[label] from logits sharded over the vocab dim
on the tp group, in fp32 whatever the logits' dtype.  The loss needs
three collectives: the max (an all-reduce MAX), the sum of exponentials
and the target logit (all-reduces, the target picked on the rank whose
vocab range holds the label, zero elsewhere).  Label smoothing averages
the log probabilities over the global vocab, as in the JAX package.
Without a tp group (tp = 1) the collectives are the identity.

Two backward strategies, as in the JAX package:

* unfused: plain autograd through the fp32 upcast (the max shift is
  detached; it changes nothing but stability); the sums go through
  `reduce_from_tensor_model_parallel_region` (all-reduce forward,
  identity backward: the loss is replicated over tp, so each rank's
  backward touches only its own shard).
* fused (`_FusedXent`, a `torch.autograd.Function`): the forward saves
  only the logits in their own dtype and the fp32 log-sum-exp per token;
  the backward rebuilds softmax(x) - q on the rank's shard in fp32 and
  emits g * (softmax - q) in the logits' dtype.  With bf16 logits that
  keeps the (S, B, V/tp) fp32 upcast out of the saved activations.

`fused=None` picks fused exactly when the logits are not fp32.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.collectives import (
    reduce_from_tensor_model_parallel_region as _reduce)
from apex_tpu_torch.parallel.mesh import TP_AXIS


def _targets(labels, vocab_per, group):
    """The labels as indices into this rank's shard (0 where the label
    lies on another rank) and the mask of those that lie here."""
    local = labels.long() - M.group_rank(group) * vocab_per
    valid = (local >= 0) & (local < vocab_per)
    return torch.where(valid, local, 0), valid


def _unfused(logits, labels, smoothing, axis_name):
    group = M.group_of(axis_name)
    x = logits.float()
    vocab_per = x.shape[-1]
    mx = M.all_reduce(x.detach().max(dim=-1).values, "max", group)
    lse = torch.log(_reduce(torch.sum(torch.exp(x - mx[..., None]), dim=-1),
                            axis_name)) + mx
    ids, valid = _targets(labels, vocab_per, group)
    picked = torch.gather(x, -1, ids[..., None])[..., 0]
    loss = lse - _reduce(torch.where(valid, picked, 0.0), axis_name)
    if smoothing > 0:
        vocab = vocab_per * M.group_size(group)
        mean_log_prob = _reduce(torch.sum(x, dim=-1), axis_name) / vocab - lse
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_prob
    return loss


def _fused_forward(logits, labels, smoothing, group):
    """The primal forward, with raw collectives: autograd never sees it."""
    x = logits.float()
    vocab_per = x.shape[-1]
    mx = M.all_reduce(torch.max(x, dim=-1).values, "max", group)
    lse = torch.log(M.all_reduce(torch.sum(torch.exp(x - mx[..., None]),
                                           dim=-1), "sum", group)) + mx
    ids, valid = _targets(labels, vocab_per, group)
    picked = torch.gather(x, -1, ids[..., None])[..., 0]
    loss = lse - M.all_reduce(torch.where(valid, picked, 0.0), "sum", group)
    if smoothing > 0:
        vocab = vocab_per * M.group_size(group)
        loss = ((1.0 - smoothing) * loss
                + smoothing * (lse - M.all_reduce(torch.sum(x, dim=-1),
                                                  "sum", group) / vocab))
    return loss, lse


class _FusedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing, group):
        loss, lse = _fused_forward(logits, labels, smoothing, group)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing, ctx.group = smoothing, group
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        s, group = ctx.smoothing, ctx.group
        vocab_per = logits.shape[-1]
        ids, valid = _targets(labels, vocab_per, group)
        # softmax(x) - q on this rank's shard, built in place in one fp32
        # buffer; the label's -(1 - s) only where it lies on this rank
        d = logits.to(torch.float32, copy=True).sub_(lse[..., None]).exp_()
        d.scatter_add_(-1, ids[..., None],
                       torch.where(valid, -(1.0 - s), 0.0)[..., None]
                       .to(d.dtype))
        if s > 0:
            d.sub_(s / (vocab_per * M.group_size(group)))
        return d.mul_(g[..., None]).to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, labels, smoothing: float = 0.0,
                                 axis_name: str = TP_AXIS, fused=None):
    """Per-token loss from (..., V/tp) logits, this rank's vocab shard,
    and (...) global integer labels.  fused: None (auto — fused iff the
    logits are not fp32), True/False to force.  Both paths compute the
    same fp32 math."""
    if fused is None:
        fused = logits.dtype != torch.float32
    if fused:
        return _FusedXent.apply(logits, labels, float(smoothing),
                                M.group_of(axis_name))
    return _unfused(logits, labels, smoothing, axis_name)
