"""Autograd-visible collectives — the Megatron region mappings
(counterpart of apex_tpu/parallel/collectives.py:1-154, itself ≡
apex/transformer/tensor_parallel/mappings.py:141-268).

Each region pair is a `torch.autograd.Function` whose forward and
backward run their own collective over the process group of the axis
named (default "tp": `parallel.mesh`'s tp group).  Without a group (a
world of one, or no mesh) every pair is the identity and no Function is
entered; with one, even a group of a single rank (NCCL on one card),
every collective is issued.

Forward/backward pairs (mappings.py:141-268):
  copy_to_tensor_model_parallel_region        id      / all-reduce
  reduce_from_tensor_model_parallel_region    all-reduce / id
  scatter_to_tensor_model_parallel_region     split-1 / gather-1
  gather_from_tensor_model_parallel_region    gather-1 / split-1
  scatter_to_sequence_parallel_region         split0  / gather0
  gather_from_sequence_parallel_region        gather0 / reduce-scatter0
  reduce_scatter_to_sequence_parallel_region  rs0     / gather0
  gather_from_sequence_parallel_region_no_tp_grad  gather0 / split0

`copy_to_tensor_model_parallel_region_many` is copy_to over several
tensors with one all-reduce of their flattened gradients: the sum that
Megatron's trainer makes over the sequence-parallel replicated params
(`allreduce_sequence_parallel_grads`), in the autograd graph.

`all_to_all` is the JAX package's tiled `lax.all_to_all` over a group
(the MoE exchange over "ep"): chunk i of the split dimension goes to
rank i, and the chunks received are concatenated along the concat
dimension in rank order; its backward is the inverse exchange.

A split or reduce-scatter along a dimension the group's size does not
divide raises, as the JAX package's `psum_scatter` does.
`ring_exchange` and `halo_exchange_1d` are point-to-point exchanges
(`batch_isend_irecv`) with ring neighbours.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.mesh import TP_AXIS


def _check_divides(n, size, dim, what):
    if size % n:
        raise ValueError(f"{what}: dimension {dim} of size {size} is not "
                         f"divisible by the group's {n} ranks")


def _all_reduce(x, group):
    y = x.contiguous().clone()
    return M.all_reduce(y, "sum", group)


def _all_gather(x, group, dim):
    """Every rank's `x` concatenated along `dim`, in rank order."""
    n = M.group_size(group)
    x = x.contiguous()
    out = x.new_empty((n,) + tuple(x.shape))
    M.all_gather(out.view(-1), x.view(-1), group)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    return out.movedim(0, dim).reshape(shape)


def _split(x, group, dim):
    """This rank's slice of `x` along `dim` (a copy)."""
    n = M.group_size(group)
    _check_divides(n, x.shape[dim], dim, "split")
    local = x.shape[dim] // n
    return x.narrow(dim, M.group_rank(group) * local, local).contiguous()


def _reduce_scatter(x, group):
    """The sum over ranks of `x`, this rank keeping its slice of dim 0."""
    n = M.group_size(group)
    _check_divides(n, x.shape[0], 0, "reduce-scatter")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    M.reduce_scatter(out.view(-1), x.view(-1), group)
    return out


def _make_pair(name, fwd, bwd):
    """A region collective: `fwd(x, group)` forward, `bwd(g, group)` its
    backward; the identity without a group."""

    class Pair(torch.autograd.Function):

        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return fwd(x, group)

        @staticmethod
        def backward(ctx, g):
            return bwd(g, ctx.group), None

    Pair.__name__ = Pair.__qualname__ = f"_{name}"

    def fn(x, axis_name: str = TP_AXIS):
        group = M.group_of(axis_name)
        if group is None:
            return x
        return Pair.apply(x, group)

    fn.__name__ = fn.__qualname__ = name
    return fn


_last = -1

copy_to_tensor_model_parallel_region = _make_pair(
    "copy_to_tensor_model_parallel_region",
    lambda x, g: x,
    _all_reduce)

reduce_from_tensor_model_parallel_region = _make_pair(
    "reduce_from_tensor_model_parallel_region",
    _all_reduce,
    lambda dy, g: dy)

scatter_to_tensor_model_parallel_region = _make_pair(
    "scatter_to_tensor_model_parallel_region",
    lambda x, g: _split(x, g, _last),
    lambda dy, g: _all_gather(dy, g, _last))

gather_from_tensor_model_parallel_region = _make_pair(
    "gather_from_tensor_model_parallel_region",
    lambda x, g: _all_gather(x, g, _last),
    lambda dy, g: _split(dy, g, _last))

scatter_to_sequence_parallel_region = _make_pair(
    "scatter_to_sequence_parallel_region",
    lambda x, g: _split(x, g, 0),
    lambda dy, g: _all_gather(dy, g, 0))

class _CopyToMany(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return xs

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        M.all_reduce(flat, "sum", ctx.group)
        parts = flat.split([g.numel() for g in gs])
        return (None, *(p.view_as(g) for p, g in zip(parts, gs)))


def copy_to_tensor_model_parallel_region_many(xs, axis_name: str = TP_AXIS):
    """`copy_to_tensor_model_parallel_region` of each tensor of `xs`
    (a tuple back), their gradients summed over the group by one
    all-reduce of them flattened together (in their common dtype), run
    once every one of them has its gradient; `xs` itself without a
    group."""
    group = M.group_of(axis_name)
    if group is None or not xs:
        return tuple(xs)
    return _CopyToMany.apply(group, *xs)


# tensor_parallel_output_grad=True (mappings.py:232-247): the backward is a
# reduce-scatter, because the tp region downstream leaves a partial sum of
# the gradient on every rank
gather_from_sequence_parallel_region = _make_pair(
    "gather_from_sequence_parallel_region",
    lambda x, g: _all_gather(x, g, 0),
    _reduce_scatter)

# tensor_parallel_output_grad=False: the backward is a plain split
gather_from_sequence_parallel_region_no_tp_grad = _make_pair(
    "gather_from_sequence_parallel_region_no_tp_grad",
    lambda x, g: _all_gather(x, g, 0),
    lambda dy, g: _split(dy, g, 0))

reduce_scatter_to_sequence_parallel_region = _make_pair(
    "reduce_scatter_to_sequence_parallel_region",
    _reduce_scatter,
    lambda dy, g: _all_gather(dy, g, 0))


def _tiled_all_to_all(x, group, split_dim, concat_dim):
    """One `all_to_all_single`: x cut into n chunks along `split_dim`,
    chunk i to rank i; the n chunks received (one from each rank, in
    rank order) concatenated along `concat_dim` of a chunk."""
    n = M.group_size(group)
    _check_divides(n, x.shape[split_dim], split_dim, "all_to_all")
    shape = list(x.shape)
    chunk = shape[:split_dim] + [shape[split_dim] // n] + shape[split_dim + 1:]
    send = x.reshape(shape[:split_dim] + [n] + chunk[split_dim:])
    send = send.movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    M.all_to_all(recv, send, group)
    out = chunk[:concat_dim] + [n * chunk[concat_dim]] + chunk[concat_dim + 1:]
    return recv.movedim(0, concat_dim).reshape(out)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _tiled_all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_tiled_all_to_all(g, ctx.group, concat_dim, split_dim),
                None, None, None)


def all_to_all(x, axis_name, split_dim: int = 0, concat_dim: int = 1):
    """≡ `lax.all_to_all(x, axis_name, split_dim, concat_dim, tiled=True)`
    over the group of `axis_name` ("ep" for the MoE exchange): this rank's
    chunk i of `split_dim` goes to rank i, and rank i's chunk for this
    rank lands at the i-th place of `concat_dim`.  Its gradient is the
    inverse exchange.  A group of one rank (or none) is the identity: no
    collective is issued."""
    group = M.group_of(axis_name)
    if M.group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim % x.dim(), concat_dim % x.dim())


def ring_hop(x, group, shift: int = 1):
    """Start sending `x` to rank (r + shift) mod n of `group` and
    receiving its (r - shift) mod n neighbour's into a new buffer.
    Returns (buffer, work handles); wait on the handles before reading
    the buffer.  A group of one rank (or None) is its own neighbour: a
    copy, no handles."""
    n = M.group_size(group)
    x = x.contiguous()
    if n == 1:
        return x.clone(), []
    r = M.group_rank(group)
    buf = torch.empty_like(x)
    return buf, M.exchange([(x, (r + shift) % n, buf, (r - shift) % n)],
                           group)


def ring_exchange(x, axis_name: str = TP_AXIS, shift: int = 1):
    """Rank r's `x` to rank (r + shift) mod n: every rank returns its
    (r - shift) mod n neighbour's tensor (≡ the JAX package's
    `ring_exchange`, a `ppermute`, and the reference's halo-exchange
    NCCL p2p)."""
    buf, works = ring_hop(x, M.group_of(axis_name), shift)
    for w in works:
        w.wait()
    return buf


def halo_exchange_1d(x, axis_name: str, halo: int, dim: int = 0):
    """Exchange `halo`-wide boundary slabs with both ring neighbours
    along `dim` (≡ PeerHaloExchanger1d / HaloExchangerSendRecv).
    Returns (left_halo, right_halo): the previous rank's last `halo`
    rows and the next rank's first, for the caller to concatenate."""
    group = M.group_of(axis_name)
    n = M.group_size(group)
    top = x.narrow(dim, 0, halo).contiguous()
    bot = x.narrow(dim, x.shape[dim] - halo, halo).contiguous()
    if n == 1:
        return bot.clone(), top.clone()
    r = M.group_rank(group)
    left, right = torch.empty_like(bot), torch.empty_like(top)
    for w in M.exchange([(bot, (r + 1) % n, left, (r - 1) % n),
                         (top, (r - 1) % n, right, (r + 1) % n)], group):
        w.wait()
    return left, right
