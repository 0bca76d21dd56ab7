"""Stage-to-stage activation transfer (counterpart of
apex_tpu/transformer/pipeline_parallel/p2p_communication.py:28-69,
itself ≡ apex/transformer/pipeline_parallel/p2p_communication.py:48-690).

The JAX package shifts activations one stage along the pp mesh axis with
`lax.ppermute`; reverse-mode AD turns a +1 shift into a -1 shift.  Here a
shift is one point-to-point exchange over the pp process group
(`parallel.collectives.ring_hop`, a `batch_isend_irecv` of one send to
stage s + delta and one receive from stage s - delta), and the public
shifts are autograd Functions whose backward is the opposite hop.  Every
rank of the pp group must issue every hop, in the same order: a send is
everyone's receive.  Over a group of one rank a hop is a copy; with no
group (a world of one, or no mesh) the shift is the identity.

The 8 reference ops (recv_forward … send_forward_backward_recv_forward_
backward, p2p_communication.py:385-690) reduce, as in the JAX package,
to the forward and backward shifts; the aliases keep their names.
`FutureTensor` pairs a tensor with the work handles of its exchange.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.collectives import ring_hop
from apex_tpu_torch.parallel.mesh import PP_AXIS


def shift(x, group, delta: int):
    """Stage s's `x` to stage (s + delta) mod n of `group`: every rank
    returns its (s - delta) mod n neighbour's tensor, outside autograd
    (the schedules' hop).  `x` itself without a group."""
    if group is None:
        return x
    buf, works = ring_hop(x, group, delta)
    for w in works:
        w.wait()
    return buf


class _Shift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, delta):
        ctx.group, ctx.delta = group, delta
        return shift(x, group, delta)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -ctx.delta), None, None


def _shift_fn(x, axis_name, delta):
    group = M.group_of(axis_name)
    if group is None:
        return x
    return _Shift.apply(x, group, delta)


def send_forward_recv_forward(x, axis_name: str = PP_AXIS):
    """Shift activations one stage forward (stage i → i+1); its backward
    shifts the gradient back.  ≡ send_forward + recv_forward
    (p2p_communication.py:385-475)."""
    return _shift_fn(x, axis_name, +1)


def send_backward_recv_backward(g, axis_name: str = PP_AXIS):
    """Shift gradients one stage backward (stage i → i-1).
    ≡ send_backward + recv_backward (p2p_communication.py:478-568)."""
    return _shift_fn(g, axis_name, -1)


# aliases matching the reference op names; each pair is one exchange
recv_forward = send_forward = send_forward_recv_forward
recv_backward = send_backward = send_backward_recv_backward


def send_forward_backward_recv_forward_backward(x, g,
                                                axis_name: str = PP_AXIS):
    """≡ p2p_communication.py:571-690 (the fused steady-state 1F1B op):
    the forward shift of `x` and the backward shift of `g`, in that
    order."""
    return _shift_fn(x, axis_name, +1), _shift_fn(g, axis_name, -1)


class FutureTensor:
    """≡ p2p_communication.FutureTensor (p2p_communication.py:34-45): a
    tensor and the outstanding work handles of the exchange that fills
    it (e.g. `ring_hop`'s); `get()` waits on them and returns the
    tensor.  On the card a wait orders the current stream after the
    exchange and does not block the host."""

    def __init__(self, tensor, works=()):
        self.tensor = tensor
        self.works = list(works)

    def get(self):
        for w in self.works:
            w.wait()
        self.works = []
        return self.tensor
