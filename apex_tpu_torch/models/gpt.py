"""GPT — configuration, seeded init, the JAX-params converter and the
tensor/sequence-parallel training forward (counterpart of
apex_tpu/models/gpt.py).

Parameters are a plain nested dict of tensors in the JAX package's
layout and key names, so a checkpoint of either package maps onto the
other one name for one name:

  embed.weight            (V, H)          tied LM head
  pos_embed               (seq_len, H)
  block{i}.ln1/ln2        weight, bias    (H,)
  block{i}.qkv            weight (H, 3H), bias (3H,)   packed (3, nh, d)
  block{i}.proj           weight (H, H),  bias (H,)
  block{i}.fc1            weight (H, 4H), bias (4H,)
  block{i}.fc2            weight (4H, H), bias (H,)
  final_ln                weight, bias    (H,)

Linear weights stay (in, out), so every product reads `x @ w` exactly
as the JAX package's `_dot` does.

`GPT` is the training forward of the JAX package's `GPT`: activations
are (S, B, H), attention is causal (the flash kernel with
`use_flash_attention=True`, else the dense path: the S² scores, the
fused causal softmax kernel, the probabilities times v), the MLP is fc1
→ tanh-gelu → fc2, the LM head is the tied embedding and the loss is the
mean vocab-parallel cross entropy.

Tensor parallelism (apex_tpu/models/gpt.py:185-208, 216-290, 323-346)
runs over the tp group of `parallel.mesh` (none: tp = 1).  Each rank
holds its shard of the parameters (`partition_specs()`, a dim index or
None per leaf; `params_from_jax(..., tp_rank, tp_size)` cuts it from the
JAX tree): qkv and fc1 column-parallel, proj and fc2 row-parallel, the
embedding (and so the tied LM head) vocab-parallel.  The attention sees
num_heads / tp heads: the rank's contiguous 3H/tp columns of the packed
qkv split three ways, as the JAX package splits its shard.  Under
`sequence_parallel` the activations between the TP regions are sharded
along the sequence: the embedding's output and the positions are
scattered, and the LM head re-gathers the sequence (the gather's
backward reduce-scatter sums the vocab shards' partial gradients, so no
`copy_to` follows it, as in Megatron's `parallel_lm_logits`; the JAX
package applies both, which scales the trunk's gradients by tp).  The
LayerNorm params and the row-parallel biases, replicated and read by
sequence-sharded regions, get partial gradients on each rank: they pass
together through `copy_to_tensor_model_parallel_region_many`, one tp
all-reduce a step where the JAX package has a `copy_to` each.
`overlap_chunks` reaches the TP layers (`parallel/overlap.py`: None asks
the tuner at tp > 1, 1 on a miss or at one rank).

`GPTPipelined` (apex_tpu/models/gpt.py:351-470) runs the blocks through
the clocked pipeline of `transformer.pipeline_parallel.schedules` over
the pp group of `parallel.mesh`: the blocks are stacked (pp, chunks,
layers_per_stage, ...), global layer (c·pp + s)·lps + j at stage s,
chunk c, slot j, and each stage holds its row; the embedding, the
positions and the final LayerNorm are replicated on every stage (the
embedding runs on stage 0, the head and the cross entropy on the last
stage, and only the scalar loss crosses pp).

Dropout (`GPTConfig.dropout`) applies when `apply` / `loss` get a key, a
`torch.Generator`, as in the JAX package: on the attention weights (the
flash kernels' in-kernel mask, or `_common.dropout` on the dense path's
probabilities) and on both residual branches.  The key is folded with
the tp rank and then with each layer's index (`tensor_parallel.random`),
and a block splits its layer's key three ways; these derivations hash the
key's state and never draw from it, so a recomputed block (`remat`)
derives the same generators and draws the same masks.

Activation checkpointing (`remat=True`) wraps each block in
`torch.utils.checkpoint` (non-reentrant): `remat_policy` None recomputes
the whole block in the backward; "dots" keeps every matmul's output
(cuBLAS `mm` / `bmm` / `addmm`) and recomputes the rest, the flash
kernels included, as `checkpoint_dots` treats a `pallas_call`;
"names:a,b" keeps only the block's tensors tagged with those
`REMAT_TAGS` (`_cn`), through selective-checkpoint policies.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import _common
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.fused_dense import qkv_split_heads
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.softmax import scaled_upper_triang_masked_softmax
from apex_tpu_torch.parallel.collectives import (
    copy_to_tensor_model_parallel_region,
    copy_to_tensor_model_parallel_region_many,
    gather_from_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
)
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.mesh import PP_AXIS, TP_AXIS
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    shard_tree,
    shard_tree_axes,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    fold_in,
    model_parallel_fold_in,
    split,
)

# The tags `_cn` puts on the block's tensors — the single source of truth
# shared by the block and remat_policy validation (the JAX package's).
REMAT_TAGS = frozenset({"qkv", "attn_ctx", "attn_out", "ffn1", "ffn_out"})

# the matmuls whose outputs the "dots" policy keeps
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})

# the replicated leaves of a block that sequence parallelism leaves with
# partial gradients
_SP_SUMMED = (("ln1", "weight"), ("ln1", "bias"), ("ln2", "weight"),
              ("ln2", "bias"), ("proj", "bias"), ("fc2", "bias"))


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    seq_len: int = 1024
    hidden: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_mult: int = 4
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32
    # LM-head logits dtype: None keeps fp32 logits; bf16 halves the
    # (S, B, V) traffic (the cross entropy upcasts inside either way)
    logits_dtype: Optional[torch.dtype] = None
    sequence_parallel: bool = False
    use_flash_attention: bool = False
    # flash attention's kernel-shape knobs (the JAX package's fields).
    # All None: the flash kernel consults the tuner (apex_tpu_torch.tune)
    # for this shape, dtype and device kind, and a miss keeps the
    # unpacked kernels, so an untuned machine runs the kernels it ran
    # before.  attn_heads_per_step > 1 packs that many heads into each
    # block of the packed kernels; the CUDA tile is 64 x 64 whatever
    # attn_block_q / attn_block_k say (they are validated only).
    attn_block_q: Any = None
    attn_block_k: Any = None
    attn_heads_per_step: Any = None
    # the TP layers' chunked compute/collective overlap depth
    # (parallel/overlap.py): None asks the tuner (`overlap_chunks`, 1 on
    # a miss: the monolithic spelling), an int forces it
    overlap_chunks: Any = None
    remat: bool = False            # activation checkpointing per block
    # what the per-block checkpoint may keep (the JAX package's dial):
    #   None        — keep nothing, recompute the whole block
    #   "dots"      — keep matmul outputs, recompute the rest
    #   "names:a,b" — keep only the listed REMAT_TAGS tensors
    remat_policy: Any = None
    # the cross entropy's backward (the JAX package's field): None picks
    # the fused one iff the logits are not fp32, True / False force it
    fused_xent: Any = None
    axis_name: str = TP_AXIS

    @property
    def head_dim(self):
        return self.hidden // self.num_heads


# preset sizes ≡ apex_tpu.models.gpt
GPT2_350M = dict(hidden=1024, num_layers=24, num_heads=16)
GPT2_1p3B = dict(hidden=2048, num_layers=24, num_heads=32)


def init_gpt_params(cfg: GPTConfig, seed: int = 0, device=None) -> dict:
    """Random GPT weights from a `torch.Generator` seeded with `seed`,
    with the distributions of the JAX package's `GPT.init`: embeddings
    N(0, 0.02²), qkv/fc1 N(0, 0.02²), proj/fc2 N(0, (0.02/√(2L))²),
    zero biases, LayerNorm weight 1 and bias 0.  The two frameworks draw
    different numbers from one seed; tests that need both packages on
    one set of weights convert the JAX tree with `params_from_jax`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = cfg
    h, f = c.hidden, c.ffn_mult * c.hidden
    out_std = 0.02 / math.sqrt(2.0 * c.num_layers)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * std).to(c.dtype)

    def zeros(n):
        return torch.zeros(n, device=dev, dtype=c.dtype)

    def ln():
        return {"weight": torch.ones(h, device=dev, dtype=c.dtype),
                "bias": zeros(h)}

    params = {
        "embed": {"weight": normal((c.vocab_size, h), 0.02)},
        "pos_embed": normal((c.seq_len, h), 0.02),
        "final_ln": ln(),
    }
    for i in range(c.num_layers):
        params[f"block{i}"] = {
            "ln1": ln(),
            "qkv": {"weight": normal((h, 3 * h), 0.02), "bias": zeros(3 * h)},
            "proj": {"weight": normal((h, h), out_std), "bias": zeros(h)},
            "ln2": ln(),
            "fc1": {"weight": normal((h, f), 0.02), "bias": zeros(f)},
            "fc2": {"weight": normal((f, h), out_std), "bias": zeros(h)},
        }
    return params


def partition_specs(cfg: GPTConfig) -> dict:
    """The tp dim of every leaf of `init_gpt_params` (None: replicated)
    ≡ the JAX package's `GPT.partition_specs`."""
    col = {"weight": 1, "bias": 0}
    row = {"weight": 0, "bias": None}
    ln = {"weight": None, "bias": None}
    specs = {"embed": {"weight": 0}, "pos_embed": None, "final_ln": dict(ln)}
    for i in range(cfg.num_layers):
        specs[f"block{i}"] = {"ln1": dict(ln), "qkv": dict(col),
                              "proj": dict(row), "ln2": dict(ln),
                              "fc1": dict(col), "fc2": dict(row)}
    return specs


def pipelined_partition_specs(cfg: GPTConfig) -> dict:
    """The partition specs of `GPTPipelined`'s parameters: the leaves of
    `blocks` (pp, chunks, lps, ...) as a tuple naming each dim's axis
    ("pp" first, "tp" where `partition_specs` cuts the layer's leaf),
    the replicated leaves as `partition_specs` has them."""
    flat = partition_specs(dataclasses.replace(cfg, num_layers=1))
    block = flat.pop("block0")

    def stacked(dim, rank):
        names = [None] * rank
        if dim is not None:
            names[dim] = TP_AXIS
        return (PP_AXIS, None, None) + tuple(names)

    flat["blocks"] = {
        mod: {k: stacked(d, 2 if k == "weight" and mod not in ("ln1", "ln2")
                         else 1) for k, d in leaves.items()}
        for mod, leaves in block.items()}
    return flat


def params_from_jax(tree: Mapping[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None, *,
                    tp_rank: int = 0, tp_size: int = 1,
                    pp_rank: int = 0, pp_size: int = 1) -> dict:
    """The JAX package's GPT parameter pytree, given as nested dicts of
    numpy arrays (e.g. `jax.tree_util.tree_map(np.asarray, params)`),
    as the port's parameters on `device`: same keys, same layouts
    (Linear weights (in, out), embedding (V, H)).  `dtype` casts every
    leaf; None keeps each array's own float type.  With `tp_size` > 1,
    tp rank `tp_rank`'s shards, each leaf cut along its
    `partition_specs` dim (the shard `shard_map` hands that rank).  A
    `GPTPipelined` tree (its stacked `blocks`) is cut over pp too:
    `blocks[pp_rank]` (its leading dim kept, of size 1) cut over tp,
    beside the replicated embedding, positions and final LayerNorm."""
    dev = resolve_device(device)

    def convert(x):
        if isinstance(x, Mapping):
            return {k: convert(v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":   # ml_dtypes: no torch mapping
            t = torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(arr)           # a copy, never a view
        if dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    params = convert(tree)
    if "blocks" in params:
        return shard_tree_axes(
            params, pipelined_partition_specs(GPTConfig(num_layers=1)),
            {TP_AXIS: (tp_rank, tp_size), PP_AXIS: (pp_rank, pp_size)})
    if tp_size == 1:
        return params
    n_layers = sum(k.startswith("block") for k in params)
    return shard_tree(params, partition_specs(GPTConfig(num_layers=n_layers)),
                      tp_rank, tp_size)


def _remat_names(policy) -> Optional[tuple]:
    """The tags a "names:a,b" policy keeps, checked against REMAT_TAGS
    with the JAX package's message; None for another policy."""
    if not (isinstance(policy, str) and policy.startswith("names:")):
        return None
    names = tuple(n for n in policy[6:].split(",") if n)
    bad = [n for n in names if n not in REMAT_TAGS]
    if bad:
        raise ValueError(
            f"remat_policy names {bad} do not match any "
            f"checkpoint_name tag in _block; known tags: "
            f"{sorted(REMAT_TAGS)}")
    return names


class GPT:
    """The GPT LM's training forward ≡ the JAX package's `GPT`, over the
    nested parameter dict of `init_gpt_params` / `params_from_jax` (this
    tp rank's shards of it; module docstring).

    Attention follows `use_flash_attention`: the flash kernel, or (the
    default, as in the JAX package) the dense path through the causal
    scaled softmax kernel.  Dropout applies when `apply` / `loss` get a
    key, and `remat` checkpoints each block (module docstring)."""

    def __init__(self, config: GPTConfig):
        c = config
        if c.hidden % c.num_heads:
            raise ValueError(f"num_heads={c.num_heads} must divide "
                             f"hidden={c.hidden}")
        self.c = c
        # the tag `_cn` has just named, read by the "names:" policy
        self._pending_tag = None
        h, f = c.hidden, c.ffn_mult * c.hidden
        tp = dict(sequence_parallel=c.sequence_parallel,
                  axis_name=c.axis_name, overlap_chunks=c.overlap_chunks)
        self.embed = VocabParallelEmbedding(
            c.vocab_size, h, axis_name=c.axis_name,
            sequence_parallel=c.sequence_parallel)
        # `_row` adds the row-parallel biases (summed over tp under
        # sequence parallelism by `_sp_summed`)
        self.blocks = [(ColumnParallelLinear(h, 3 * h, **tp),
                        RowParallelLinear(h, h, bias=False, **tp),
                        ColumnParallelLinear(h, f, **tp),
                        RowParallelLinear(f, h, bias=False, **tp))
                       for _ in range(c.num_layers)]

    def init(self, seed: int = 0, device=None) -> dict:
        """The whole (global) parameters; `init_sharded_optimizer` keeps
        this rank's shards of them."""
        return init_gpt_params(self.c, seed, device)

    def partition_specs(self) -> dict:
        """The tp dim of every leaf (None: replicated)."""
        return partition_specs(self.c)

    def _sp_summed(self, params):
        """`params` with the replicated leaves that sequence-sharded
        regions read (`_SP_SUMMED` and the final LayerNorm's) through one
        `copy_to_tensor_model_parallel_region_many`: their gradients,
        partial sums on each rank, summed over tp by one all-reduce."""
        c = self.c
        out = dict(params, final_ln=dict(params["final_ln"]))
        slots = [(out["final_ln"], "weight"), (out["final_ln"], "bias")]
        for i in range(c.num_layers):
            blk = out[f"block{i}"] = dict(params[f"block{i}"])
            for m in {m for m, _ in _SP_SUMMED}:
                blk[m] = dict(blk[m])
            slots += [(blk[m], k) for m, k in _SP_SUMMED]
        leaves = copy_to_tensor_model_parallel_region_many(
            [d[k] for d, k in slots], c.axis_name)
        for (d, k), leaf in zip(slots, leaves):
            d[k] = leaf
        return out

    @staticmethod
    def _row(mod, p, x):
        """A row-parallel layer, its bias added after the reduction as
        `RowParallelLinear` adds it."""
        y = mod.apply(p, x)
        return y + p["bias"].to(y.dtype)

    def _dropout(self, key, x):
        return _common.dropout(key, self.c.dropout, x)

    def _cn(self, x, name):
        """The JAX package's `checkpoint_name`: under a "names:" remat
        policy, an alias of x that the policy may keep; otherwise x
        itself (no op)."""
        assert name in REMAT_TAGS, name  # keep REMAT_TAGS in sync with _block
        c = self.c
        if not (c.remat and _remat_names(c.remat_policy) is not None):
            return x
        self._pending_tag = name
        return torch.ops.aten.alias.default(x)

    def _attention(self, bp, qkv_mod, proj_mod, x, key=None):
        """x: (S[/tp], B, H) → attention output (S[/tp], B, H), the heads
        sharded over tp; `key`: the attention weights' dropout key (None:
        no dropout)."""
        c = self.c
        qkv = qkv_mod.apply(bp["qkv"], x)                  # (S, B, 3H/tp)
        qkv = self._cn(qkv, "qkv")
        s, b, _ = qkv.shape
        q, k, v = qkv_split_heads(qkv, qkv.shape[-1] // (3 * c.head_dim),
                                  c.head_dim)
        scale = 1.0 / math.sqrt(c.head_dim)
        if c.use_flash_attention:
            rate = c.dropout if key is not None else 0.0
            ctx = flash_attention(q, k, v, causal=True, softmax_scale=scale,
                                  dropout_rate=rate,
                                  dropout_key=key if rate > 0 else None,
                                  block_q=c.attn_block_q,
                                  block_k=c.attn_block_k,
                                  heads_per_step=c.attn_heads_per_step)
        else:
            # the two products stay GEMMs (XLA's einsums in the JAX
            # package), each rounded once to the compute dtype
            scores = torch.matmul(q, k.transpose(-2, -1))  # (B, nh, S, S)
            probs = scaled_upper_triang_masked_softmax(
                scores.reshape(-1, s, s), scale).reshape(scores.shape)
            probs = self._dropout(key, probs)
            ctx = torch.matmul(probs, v)                   # (B, nh, S, d)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, -1)    # (S, B, H/tp)
        ctx = self._cn(ctx, "attn_ctx")
        return self._row(proj_mod, bp["proj"], ctx)

    def _block(self, i, params, x, key=None):
        """ln1 → qkv → split heads → attention → proj → dropout →
        residual, then ln2 → fc1 → tanh-gelu → fc2 → dropout → residual;
        `key` (the layer's) splits three ways: attention weights and the
        two residual branches."""
        qkv_mod, proj_mod, fc1, fc2 = self.blocks[i]
        k1 = k2 = k3 = None
        if key is not None:
            k1, k2, k3 = split(key, 3)
        ln = params["ln1"]
        h = fused_layer_norm(x, ln["weight"], ln["bias"])
        attn = self._attention(params, qkv_mod, proj_mod, h, k1)
        attn = self._cn(attn, "attn_out")
        x = x + self._dropout(k2, attn)
        ln = params["ln2"]
        h = fused_layer_norm(x, ln["weight"], ln["bias"])
        m = fc1.apply(params["fc1"], h)
        m = self._cn(m, "ffn1")
        m = F.gelu(m, approximate="tanh")
        m = self._row(fc2, params["fc2"], m)
        m = self._cn(m, "ffn_out")
        return x + self._dropout(k3, m)

    def _keeps(self, ctx, func, *args, **kwargs):
        """The selective-checkpoint policy of `remat_policy` ("dots" or
        "names:..."): keep a matmul's output, or a tag's alias."""
        from torch.utils.checkpoint import CheckpointPolicy

        names = _remat_names(self.c.remat_policy)
        if names is None:
            keep = func in _DOT_OPS
        else:
            keep = (func is torch.ops.aten.alias.default
                    and self._pending_tag in names)
            if func is torch.ops.aten.alias.default:
                self._pending_tag = None
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def _remat_kwargs(self) -> dict:
        """torch.utils.checkpoint's arguments for `remat_policy`, or the
        JAX package's ValueError for a policy it does not know."""
        c = self.c
        if c.remat_policy is None:
            return {}
        if (c.remat_policy == "dots"
                or _remat_names(c.remat_policy) is not None):
            from torch.utils.checkpoint import (
                create_selective_checkpoint_contexts)
            return {"context_fn": functools.partial(
                create_selective_checkpoint_contexts, self._keeps)}
        raise ValueError(
            f"unknown remat_policy {c.remat_policy!r}; "
            "expected None, 'dots', or 'names:...'")

    def apply(self, params, tokens, key=None):
        """tokens: (B, S) global int ids (replicated over tp) → final
        hidden states (S[/tp], B, H); `key` (a `torch.Generator`, or None
        for no dropout): folded with the tp rank, then with each layer's
        index, before the layer (and its checkpoint) runs."""
        from torch.utils.checkpoint import checkpoint

        c = self.c
        ckpt = self._remat_kwargs() if c.remat else None
        if c.sequence_parallel:
            params = self._sp_summed(params)
        h = self.embed.apply(params["embed"], tokens.T)    # (S[/tp], B, H)
        pos = params["pos_embed"][:tokens.shape[1]][:, None, :]
        if c.sequence_parallel:
            pos = scatter_to_sequence_parallel_region(pos, c.axis_name)
        h = h + pos.to(h.dtype)
        if key is not None:
            key = model_parallel_fold_in(key, c.axis_name)
        for i in range(c.num_layers):
            bk = None if key is None else fold_in(key, i)
            if ckpt is None:
                h = self._block(i, params[f"block{i}"], h, bk)
            else:
                h = checkpoint(functools.partial(self._block, i),
                               params[f"block{i}"], h, bk,
                               use_reentrant=False, preserve_rng_state=False,
                               **ckpt)
        ln = params["final_ln"]
        return fused_layer_norm(h, ln["weight"], ln["bias"])

    def logits_local(self, params, h):
        """Tied-embedding LM head: (S, B, V/tp) vocab-sharded logits, the
        fp32-accumulated product rounded once to `logits_dtype` (fp32
        when None).  Under sequence parallelism the hidden states are
        re-gathered first, and the gather's backward sums the gradient over
        tp; without it `copy_to` does."""
        c = self.c
        if c.sequence_parallel:
            h = gather_from_sequence_parallel_region(h, c.axis_name)
        else:
            h = copy_to_tensor_model_parallel_region(h, c.axis_name)
        w = params["embed"]["weight"]
        out_dtype = self.c.logits_dtype or torch.float32
        if out_dtype == h.dtype:
            return torch.matmul(h, w.t())
        return torch.matmul(h.float(), w.float().t()).to(out_dtype)

    def loss(self, params, tokens, labels, key=None):
        """Mean LM loss; tokens/labels (B, S); `key` as `apply` takes it."""
        h = self.apply(params, tokens, key)
        logits = self.logits_local(params, h)              # (S, B, V/tp)
        loss = vocab_parallel_cross_entropy(logits, labels.T,
                                            axis_name=self.c.axis_name,
                                            fused=self.c.fused_xent)
        return torch.mean(loss)


class GPTPipelined(GPT):
    """GPT over the (pp, dp, tp) groups ≡ the JAX package's `GPTPipelined`
    (apex_tpu/models/gpt.py:351-470): the blocks stacked per stage and
    cut over pp, the embedding, positions and final LayerNorm replicated
    on every stage (each stage's copy gets a partial gradient; the train
    step sums them over pp), microbatched through the clocked pipeline
    (`pipeline_parallel.schedules.spmd_pipeline`).

    `init` gives the whole stacked tree; a rank holds `blocks[pp_rank]`
    (leading dim 1 kept, as `shard_map` hands it) cut over tp
    (`init_sharded_optimizer`, `params_from_jax`).  The stage function
    applies a stage's layers with no dropout key, as the JAX package's
    does, and no per-block remat: `remat_stage` and `checkpoint_window`
    are the pipeline's dials."""

    def __init__(self, config: GPTConfig, num_microbatches: int,
                 pipeline_parallel_size: int, num_model_chunks: int = 1,
                 remat_stage: bool = False, checkpoint_window=None):
        super().__init__(config)
        c = config
        self.num_microbatches = num_microbatches
        self.pp = self.pipeline_parallel_size = pipeline_parallel_size
        self.chunks = num_model_chunks
        self.remat_stage = remat_stage
        self.checkpoint_window = checkpoint_window
        if c.num_layers % (self.pp * self.chunks):
            raise ValueError("num_layers must divide pp * num_model_chunks")
        self.layers_per_stage = c.num_layers // (self.pp * self.chunks)

    def stack(self, flat_params: dict) -> dict:
        """`GPT`'s tree (block0 … block{L-1}) as this model's: the blocks'
        leaves stacked to (pp, chunks, lps, ...), global layer
        ((c·pp + s)·lps + j) at [s, c, j]."""
        c = self.c
        out = {k: v for k, v in flat_params.items()
               if not k.startswith("block")}
        blocks = [flat_params[f"block{i}"] for i in range(c.num_layers)]

        def stacked(*leaves):
            x = torch.stack(leaves)
            x = x.reshape((self.chunks, self.pp, self.layers_per_stage)
                          + tuple(x.shape[1:]))
            return x.transpose(0, 1).contiguous()

        out["blocks"] = {
            mod: {k: stacked(*(b[mod][k] for b in blocks))
                  for k in blocks[0][mod]} for mod in blocks[0]}
        return out

    def init(self, seed: int = 0, device=None) -> dict:
        """The whole (global) stacked parameters, `GPT.init`'s weights."""
        return self.stack(super().init(seed, device))

    def partition_specs(self) -> dict:
        """The axes each leaf is cut over: the blocks' pp dim first
        (`pipelined_partition_specs`)."""
        return pipelined_partition_specs(self.c)

    def _sp_summed(self, params):
        """Under sequence parallelism the stacked LayerNorm params and
        row-parallel biases and the final LayerNorm's, through one
        `copy_to_tensor_model_parallel_region_many` (`GPT._sp_summed`)."""
        out = dict(params, final_ln=dict(params["final_ln"]),
                   blocks=dict(params["blocks"]))
        blk = out["blocks"]
        for m in {m for m, _ in _SP_SUMMED}:
            blk[m] = dict(blk[m])
        slots = [(out["final_ln"], "weight"), (out["final_ln"], "bias")]
        slots += [(blk[m], k) for m, k in _SP_SUMMED]
        leaves = copy_to_tensor_model_parallel_region_many(
            [d[k] for d, k in slots], self.c.axis_name)
        for (d, k), leaf in zip(slots, leaves):
            d[k] = leaf
        return out

    def _stage_fn(self, stage_blocks, h, chunk):
        """Apply one chunk's layers_per_stage blocks in order.  The
        stacked leaves are unbound once: the backward then stacks the
        layers' gradients in one copy, where indexing each layer would
        scatter each into a zeroed stack-sized tensor (lax.scan's
        transpose stacks them in the JAX package)."""
        layers = {m: {k: v.unbind(0) for k, v in leaves.items()}
                  for m, leaves in stage_blocks.items()}
        for j in range(self.layers_per_stage):
            bp = {m: {k: v[j] for k, v in leaves.items()}
                  for m, leaves in layers.items()}
            h = self._block(0, bp, h)
        return h

    def _embed_one(self, params, ids):
        """One microbatch's (mb, S) ids → (S[/tp], mb, H) embeddings."""
        c = self.c
        h = self.embed.apply(params["embed"], ids.T)
        pos = params["pos_embed"][:ids.shape[1]][:, None, :]
        if c.sequence_parallel:
            pos = scatter_to_sequence_parallel_region(pos, c.axis_name)
        return h + pos.to(h.dtype)

    def _head_one(self, params, h, labels):
        """The last stage's head on one microbatch: final LayerNorm, the
        tied LM head, the mean vocab-parallel cross entropy."""
        ln = params["final_ln"]
        h = fused_layer_norm(h, ln["weight"], ln["bias"])
        logits = self.logits_local(params, h)
        return torch.mean(vocab_parallel_cross_entropy(
            logits, labels, axis_name=self.c.axis_name,
            fused=self.c.fused_xent))

    def loss(self, params, tokens, labels, key=None):
        """Mean LM loss over tokens/labels (B, S), B = num_microbatches ×
        the microbatch size; `params` this rank's shard.  `key` is taken
        for `GPT.loss`'s signature and unused (no dropout, as in the JAX
        package)."""
        from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
            spmd_pipeline)

        c = self.c
        m = self.num_microbatches
        group = M.group_of(PP_AXIS)
        if M.group_size(group) != self.pp:
            raise ValueError(
                f"the model is cut into pp={self.pp} stages, the pp group "
                f"has {M.group_size(group)} ranks")
        B, S = tokens.shape
        if B % m:
            raise ValueError(f"batch {B} is not divisible by "
                             f"{m} microbatches")
        mb = B // m
        if c.sequence_parallel:
            params = self._sp_summed(params)
        ids = tokens.reshape(m, mb, S)
        if M.group_rank(group) == 0:
            h_mbs = torch.stack([self._embed_one(params, ids[k])
                                 for k in range(m)])
        else:    # only stage 0 reads the feed
            tp = M.group_size(M.group_of(c.axis_name))
            s_local = S // tp if c.sequence_parallel else S
            w = params["embed"]["weight"]
            h_mbs = w.new_zeros((m, s_local, mb, c.hidden))
        stage_blocks = {mod: {k: v[0] for k, v in leaves.items()}
                        for mod, leaves in params["blocks"].items()}
        lbl = labels.reshape(m, mb, S).transpose(1, 2)     # (m, S, mb)
        total = spmd_pipeline(
            self._stage_fn, stage_blocks, h_mbs,
            num_model_chunks=self.chunks, remat_stage=self.remat_stage,
            checkpoint_window=self.checkpoint_window,
            loss_fn=lambda h, lab: self._head_one(params, h, lab),
            loss_args=lbl)
        return total / m


def gpt_350m(**overrides) -> GPT:
    """GPT-350M (`GPT2_350M`), with `overrides` of any `GPTConfig` field."""
    return GPT(GPTConfig(**{**GPT2_350M, **overrides}))


def gpt_1p3b(**overrides) -> GPT:
    """GPT-1.3B (`GPT2_1p3B`), with `overrides` of any `GPTConfig` field."""
    return GPT(GPTConfig(**{**GPT2_1p3B, **overrides}))
