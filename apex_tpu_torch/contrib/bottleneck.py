"""Spatially parallel ResNet bottleneck: convolutions over images sharded
along H, with halo exchange (counterpart of apex_tpu/contrib/bottleneck.py,
itself ≡ apex.contrib.bottleneck's SpatialBottleneck and HaloExchanger
family, apex/contrib/bottleneck/bottleneck.py:603 and
halo_exchangers.py:11-127).

The fused block itself is the port's `models.resnet.Bottleneck` (cuDNN
convolutions, the channel-sums kernel's batch norms).  This module adds
the spatial form: each rank of the mesh group of `axis_name` holds a
band of rows of every image (NHWC), a 3×3 convolution first takes a
one-row halo from each ring neighbour (`parallel.collectives`' NCCL
point-to-point; the edge ranks zero theirs, the SAME padding of the
whole image), and the convolution is then valid along H and SAME along
W.  The halo exchange is differentiable (`_Halo`): its backward sends
each halo's gradient back to the rank it came from.  The reference's
four transports (all-gather, send/recv, peer memory, raw NCCL) are one
here."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from apex_tpu_torch.models.resnet import Bottleneck, conv2d, relu
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.collectives import halo_exchange_1d
from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm


class _Halo(torch.autograd.Function):
    """(left, right) = `halo_exchange_1d(x, ...)`: the previous rank's
    last and the next rank's first `halo` rows along `dim`.  Backward: a
    left halo's gradient goes back to the previous rank (its last rows),
    a right halo's to the next (its first rows)."""

    @staticmethod
    def forward(ctx, x, axis_name, halo, dim):
        ctx.axis_name, ctx.halo, ctx.dim = axis_name, halo, dim
        ctx.shape = x.shape
        return halo_exchange_1d(x, axis_name, halo, dim=dim)

    @staticmethod
    def backward(ctx, g_left, g_right):
        # my first rows were the previous rank's right halo, my last rows
        # the next rank's left halo: exchanging [g_left; g_right] gives
        # (the previous rank's g_right, the next rank's g_left)
        dim, halo = ctx.dim, ctx.halo
        both = torch.cat([g_left.contiguous(), g_right.contiguous()], dim)
        from_prev, from_next = halo_exchange_1d(both, ctx.axis_name, halo,
                                                dim=dim)
        dx = g_left.new_zeros(ctx.shape)
        dx.narrow(dim, 0, halo).add_(from_prev)
        dx.narrow(dim, ctx.shape[dim] - halo, halo).add_(from_next)
        return dx, None, None, None


def spatial_conv2d(x, w, axis_name: str = "dp", stride: int = 1):
    """A conv over H-sharded NHWC `x` with OHWI weights `w` (the JAX
    package's `spatial_conv2d`): a 1×1 conv is local; a kh×kw one takes
    (kh - 1) / 2 halo rows from each neighbour in the group of
    `axis_name` (the edge ranks' outer halos are zeros) and runs valid
    along H, SAME along W."""
    kh = w.shape[1]
    if kh == 1:
        return conv2d(x, w, stride=stride, padding="SAME")
    halo = (kh - 1) // 2
    group = M.group_of(axis_name)
    n, rank = M.group_size(group), M.group_rank(group)
    top, bot = _Halo.apply(x, axis_name, halo, 1)
    if rank == 0:
        top = torch.zeros_like(top)
    if rank == n - 1:
        bot = torch.zeros_like(bot)
    xh = torch.cat([top, x, bot], dim=1)
    y = F.conv2d(xh.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2),
                 stride=stride, padding=(0, kh // 2))
    return y.permute(0, 2, 3, 1)


def _bn(params, state, x, training, group, eps=1e-5, momentum=0.1):
    y, rm, rv = sync_batch_norm(
        x, params["scale"], params["bias"], state["running_mean"],
        state["running_var"], training=training, momentum=momentum,
        eps=eps, process_group=group)
    return y, {"running_mean": rm, "running_var": rv}


class SpatialBottleneck(Bottleneck):
    """≡ SpatialBottleneck (bottleneck.py:603): the port's Bottleneck
    whose 3×3 conv runs on H-sharded activations over the group of
    `spatial_axis`; its batch norms merge their statistics over the
    group of `axis_name` (None: local), as the JAX package's over its
    axis."""

    def __init__(self, cin, width, stride=1, downsample=False,
                 spatial_axis: str = "dp"):
        super().__init__(cin, width, stride, downsample)
        self.spatial_axis = spatial_axis

    def apply(self, params, state, x, training, axis_name=None):
        group = None if axis_name is None else M.group_of(axis_name)
        new_state = {}
        out = conv2d(x, params["conv1"])
        out, new_state["bn1"] = _bn(params["bn1"], state["bn1"], out,
                                    training, group)
        out = spatial_conv2d(relu(out), params["conv2"], self.spatial_axis,
                             stride=self.stride)
        out, new_state["bn2"] = _bn(params["bn2"], state["bn2"], out,
                                    training, group)
        out = conv2d(relu(out), params["conv3"])
        out, new_state["bn3"] = _bn(params["bn3"], state["bn3"], out,
                                    training, group)
        if self.downsample:
            sc = conv2d(x, params["conv_ds"], stride=self.stride)
            sc, new_state["bn_ds"] = _bn(params["bn_ds"], state["bn_ds"],
                                         sc, training, group)
        else:
            sc = x
        return relu(out + sc), new_state


class HaloExchanger:
    """≡ the HaloExchanger family (halo_exchangers.py:11-127): one
    transport, NCCL point-to-point over the group of `axis_name`."""

    def __init__(self, axis_name: str = "dp"):
        self.axis_name = axis_name

    def left_right_halo_exchange(self, x, halo: int, dim: int = 1):
        return halo_exchange_1d(x, self.axis_name, halo, dim=dim)


HaloExchangerNoComm = HaloExchangerAllGather = HaloExchangerSendRecv = \
    HaloExchangerPeer = HaloExchanger
