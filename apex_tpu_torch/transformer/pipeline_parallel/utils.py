"""Pipeline-parallel utilities (counterpart of
apex_tpu/transformer/pipeline_parallel/utils.py:25-109, itself ≡
apex/transformer/pipeline_parallel/utils.py): the microbatch calculator
globals (58-140), microbatch slicing (122), loss averaging over the dp
group (242), the params' L2 norm (213), left-to-right masks (303) and
the memory report (253).

`tree_map` / `tree_flatten` walk the nested dicts (keys sorted, the JAX
package's leaf order), lists and tuples the schedules take as pytrees.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.optimizer_kernels import l2norm_flat
from apex_tpu_torch.optimizers.flat import flatten
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
)

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def tree_flatten(tree):
    """(leaves, rebuild): the tensors of a pytree of dicts (keys sorted),
    lists and tuples, and the function that puts a list of that many
    leaves back in its place.  None is an empty subtree."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, rb), n in zip(parts, counts):
            out.append(rb(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def tree_map(fn, tree):
    """`fn` applied to every leaf of `tree` (structure kept)."""
    leaves, rebuild = tree_flatten(tree)
    return rebuild([fn(leaf) for leaf in leaves])


def setup_microbatch_calculator(rank: int, rampup_batch_size,
                                global_batch_size: int,
                                micro_batch_size: int,
                                data_parallel_size: int):
    """≡ utils.setup_microbatch_calculator (utils.py:58-76)."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR


def get_num_microbatches():
    """≡ utils.get_num_microbatches (utils.py:92)."""
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples, consistency_check=True):
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples,
                                               consistency_check)


def get_kth_microbatch(batch, k: int, micro_batch_size: int):
    """≡ utils.get_kth_microbatch (utils.py:122-131): rows [k·mbs,
    (k+1)·mbs) of every leaf."""
    if batch is None:
        return None
    start = k * micro_batch_size
    return tree_map(lambda x: x[start:start + micro_batch_size], batch)


def split_into_microbatches(batch, num_microbatches: int):
    """Reshape a global batch (B, ...) to (m, B/m, ...) for the pipeline
    (views)."""
    return tree_map(lambda x: x.reshape(
        (num_microbatches, x.shape[0] // num_microbatches)
        + tuple(x.shape[1:])), batch)


def average_losses_across_data_parallel_group(losses,
                                              axis_name: str = M.DP_AXIS):
    """≡ utils.average_losses_across_data_parallel_group
    (utils.py:242-250): the losses stacked in fp32 and averaged over the
    group of `axis_name` (the dp group of `parallel.mesh`; the world
    without a mesh, the identity without torch.distributed): one
    all-reduce."""
    stacked = torch.stack([torch.as_tensor(x, dtype=torch.float32)
                           .reshape(()) for x in losses])
    group = M.group_of(axis_name)
    M.all_reduce(stacked, "sum", group)
    return stacked / M.group_size(group)


def calc_params_l2_norm(params):
    """≡ utils.calc_params_l2_norm (utils.py:213-239): the fp32 L2 norm
    of every leaf, through one flat buffer; for model-parallel params sum
    the squared local norm over tp before the square root at the call
    site."""
    return l2norm_flat(flatten(params, torch.float32))


def get_ltor_masks_and_position_ids(tokens, eod_token: Optional[int] = None,
                                    reset_position_ids: bool = False,
                                    reset_attention_mask: bool = False,
                                    eod_mask_loss: bool = False):
    """≡ utils.get_ltor_masks_and_position_ids (utils.py:303-330) on the
    non-reset path, as the JAX package has it: the (B, 1, S, S) causal
    mask (True where a query may see a key), the (B, S) fp32 loss mask
    (0 at `eod_token` under `eod_mask_loss`) and the (B, S) positions."""
    b, s = tokens.shape
    dev = tokens.device
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
    attention_mask = causal.expand(b, 1, s, s)
    loss_mask = torch.ones((b, s), dtype=torch.float32, device=dev)
    if eod_mask_loss and eod_token is not None:
        loss_mask = torch.where(tokens == eod_token, 0.0, loss_mask)
    position_ids = torch.arange(s, device=dev).expand(b, s)
    return attention_mask, loss_mask, position_ids


def report_memory(name=""):
    """≡ utils.report_memory (utils.py:253-263): bytes in use on each
    visible card, from `torch.cuda.memory_stats`; without CUDA the JAX
    package's "memory stats unavailable" line."""
    stats = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            m = torch.cuda.memory_stats(i)
            stats.append(f"cuda:{i}: "
                         f"{m.get('allocated_bytes.all.current', 0) / 1e9:.2f}"
                         f"GB in use")
    else:
        stats.append("cpu: memory stats unavailable")
    return f"[{name}] " + "; ".join(stats)
