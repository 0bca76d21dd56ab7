"""Long-context LM training with ring attention on the PyTorch port:
context parallelism end to end (counterpart of
examples/long_context_training.py).

Trains a small causal transformer on ONE packed 32k-token sequence
sharded across the ranks of the world group:

* zigzag sequence sharding (`zigzag_shard`) of the tokens, the labels
  and the global position ids, so the causal ring's work a step is the
  same on every rank;
* `ring_attention(layout="zigzag")` inside the model: the flash
  kernels' chunk entry points on each chunk pair, the lse-recompute
  backward, fp32 partial gradients;
* the global position ids ride through the zigzag permutation, so the
  learned positions and the shifted-label loss stay right;
* the gradients (and the loss) averaged over the group, FusedAdam on the
  flat buffer.

The model is the JAX example's (`init_params`, `forward_loss` with
`_rms`, the tied head, gelu-tanh); `params_from_jax` carries that
example's parameters across.  One stated difference: on CUDA, q, k and
v enter `ring_attention` as bf16, because the card's flash kernels take
bf16 only (ROADMAP Queue 2 item 39), and its output comes back to fp32;
on the CPU everything stays fp32.  The JAX example's
`--force-cpu-devices` has no counterpart: the world is the launcher's.

Run on the card (a world of one):
    python examples/torch_long_context_training.py --seq 32768 --steps 3
on N ranks through the port's launcher (NCCL, one card a rank):
    python -m apex_tpu_torch.parallel.multiproc --nproc N \\
        examples/torch_long_context_training.py --seq 32768
and on the CPU with `--device cpu` (gloo under the launcher).
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from apex_tpu_torch.ops import optimizer_kernels as K  # noqa: E402
from apex_tpu_torch.ops._common import resolve_device  # noqa: E402
from apex_tpu_torch.optimizers import FusedAdam  # noqa: E402
from apex_tpu_torch.optimizers import flat as FL  # noqa: E402
from apex_tpu_torch.parallel import mesh as M  # noqa: E402
from apex_tpu_torch.parallel.context_parallel import (  # noqa: E402
    ring_attention, zigzag_shard)
from apex_tpu_torch.parallel.multiproc import init_from_env  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seq", type=int, default=32768)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                   help="cpu runs the plain versions (default: the card)")
    return p.parse_args(argv)


def init_params(seed, a, device):
    """The JAX example's parameter tree and scales (its numbers come from
    `jax.random`; these from a torch Generator seeded with `seed`)."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return (torch.randn(shape, generator=g) * 0.02).to(device)

    hd = a.hidden
    params = {"embed": normal(a.vocab, hd), "pos": normal(a.seq, hd)}
    for i in range(a.layers):
        params[f"block{i}"] = {"qkv": normal(hd, 3 * hd),
                               "proj": normal(hd, hd),
                               "fc1": normal(hd, 4 * hd),
                               "fc2": normal(4 * hd, hd)}
    return params


def params_from_jax(tree, device="cpu"):
    """The JAX example's `init_params` tree (its leaves as numpy arrays)
    as this example's parameters: the same names, shapes and values."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    import numpy as np

    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _rms(x):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)


def forward_loss(params, tokens, labels, pos_ids, a, group=None):
    """This rank's forward: tokens, labels and pos_ids are its (s_local,)
    zigzag shards; attention is the only op across ranks (the ring over
    `group`).  Returns this rank's mean token loss."""
    hd, nh = a.hidden, a.heads
    x = params["embed"][tokens] + params["pos"][pos_ids]
    attn_dtype = torch.bfloat16 if x.is_cuda else x.dtype
    for i in range(a.layers):
        blk = params[f"block{i}"]
        h = _rms(x)
        q, k, v = torch.split(h @ blk["qkv"], hd, dim=-1)

        def heads(t):  # (s, hd) -> (1, nh, s, hd/nh)
            return t.reshape(-1, nh, hd // nh).transpose(0, 1)[None].to(
                attn_dtype)

        ctx = ring_attention(heads(q), heads(k), heads(v), group,
                             causal=True, layout="zigzag")
        ctx = ctx[0].transpose(0, 1).reshape(-1, hd).to(x.dtype)
        x = x + ctx @ blk["proj"]
        h = _rms(x)
        x = x + F.gelu(h @ blk["fc1"], approximate="tanh") @ blk["fc2"]
    logits = _rms(x) @ params["embed"].T            # tied head (s, V)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, labels[:, None].long()).mean()


def make_step(opt, a, group=None):
    """step(state, tokens, labels, pos_ids) -> (state, loss): the
    gradient of this rank's loss, summed over the group in one
    all-reduce of the flat gradient and divided by its size (the JAX
    example's pmean), then one FusedAdam step on the flat buffer; the
    loss is the group's mean, a device scalar (no host sync)."""
    n = M.group_size(group)

    def step(state, tokens, labels, pos_ids):
        leaves = [p.detach().requires_grad_(True)
                  for p in FL.unflatten_leaves(state.params, opt.spec)]
        params = FL.tree_from_leaves(opt.spec, leaves)
        loss = forward_loss(params, tokens, labels, pos_ids, a, group)
        grads = torch.autograd.grad(loss, leaves)
        g = FL.flatten(FL.tree_from_leaves(opt.spec, list(grads)),
                       torch.float32, pad_to=K.FLAT_TILE,
                       align=opt.spec.align)
        M.all_reduce(g, "sum", group)
        g.div_(n)
        loss = M.all_reduce(loss.detach().clone(), "sum", group) / n
        _, state = opt.step_flat(state, g)
        return state, loss

    return step


def make_data(a, n, device, seed=1):
    """ONE long "document" with order-1 structure (the JAX example's
    recipe, from a torch Generator): tokens, their global next-token
    labels (shifted BEFORE the zigzag permutation) and position ids, each
    as its zigzag order (seq,), to be cut into n contiguous shards."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randint(0, a.vocab, (a.seq,), generator=g)
    tokens = (base + torch.roll(base, 1)) % a.vocab
    labels = torch.roll(tokens, -1)
    pos_ids = torch.arange(a.seq)
    return tuple(zigzag_shard(x[None], n, axis=1)[0].to(device)
                 for x in (tokens, labels, pos_ids))


def main(argv=None):
    a = parse(argv)
    device = resolve_device(a.device)
    joined = init_from_env(a.device)
    group = dist.group.WORLD if joined else None
    n, rank = M.group_size(group), M.group_rank(group)
    if joined and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    print(f"cp group: {n} ranks, {a.seq} tokens ({a.seq // n}/rank, "
          f"zigzag), {device}")
    params = init_params(0, a, device)
    opt = FusedAdam(lr=a.lr)
    state = opt.init(params)
    tz, lz, pz = (x.chunk(n)[rank] for x in make_data(a, n, device))
    step = make_step(opt, a, group)
    loss = float("nan")
    for i in range(a.steps):
        t0 = time.perf_counter()
        state, loss = step(state, tz, lz, pz)
        loss = float(loss)
        dt = time.perf_counter() - t0
        print(f"step {i}: loss {loss:.4f}  {dt:.2f}s  "
              f"({a.seq / dt:.0f} tok/s)")
    if joined:
        dist.destroy_process_group()
    return loss


if __name__ == "__main__":
    main()
