"""Group batch normalization, NHWC (counterpart of
apex_tpu/contrib/groupbn.py, itself ≡ apex.contrib.groupbn's
BatchNorm2d_NHWC, apex/contrib/groupbn/batch_norm.py:101, and
apex.contrib.cudnn_gbn's GroupBatchNorm2d): a batch norm whose
statistics are merged across a sub-group of ranks (`bn_group`) rather
than the whole data-parallel world.

Over the port's `parallel.sync_batchnorm.SyncBatchNorm`: the statistics
come from the channel-sums kernel (`ops.welford`) and are merged by one
all-reduce over `process_group`, where the JAX package takes the mesh
sub-axis naming the group.  `fuse_relu` and the add-ReLU with `z` (the
reference's fused epilogues) are PyTorch's own operators."""

from __future__ import annotations

from apex_tpu_torch.models.resnet import relu
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.parallel.sync_batchnorm import (SyncBatchNorm,
                                                    sync_batch_norm)


class BatchNorm2d_NHWC(SyncBatchNorm):
    """≡ BatchNorm2d_NHWC (groupbn/batch_norm.py:7-101).  `bn_group` > 1
    needs the `process_group` of the group's ranks (ValueError without
    one, as the JAX package raises without its axis name).  Its
    parameters and buffers live on the card unless `device` says
    otherwise."""

    def __init__(self, num_features, fuse_relu: bool = False,
                 bn_group: int = 1, process_group=None, *, device=None,
                 **kw):
        if bn_group > 1 and process_group is None:
            raise ValueError(
                "bn_group > 1 needs the process group of the group's ranks "
                "(e.g. torch.distributed.new_group over bn_group ranks)")
        super().__init__(num_features, process_group=process_group,
                         device=resolve_device(device), **kw)
        self.fuse_relu = fuse_relu
        self.bn_group = bn_group

    def _epilogue(self, y, z):
        if z is not None:               # use_addrelu: residual add first
            y = y + z
        if self.fuse_relu or z is not None:
            y = relu(y)
        return y

    def apply(self, params, state, x, training=True, z=None,
              process_group="__unset__"):
        """The JAX package's functional form: (y, new state)."""
        pg = self.process_group if process_group == "__unset__" \
            else process_group
        y, rm, rv = sync_batch_norm(
            x, params.get("scale"), params.get("bias"),
            state["running_mean"], state["running_var"],
            training=training, momentum=self.momentum, eps=self.eps,
            process_group=pg, channel_axis=self.channel_axis)
        return self._epilogue(y, z), {"running_mean": rm,
                                      "running_var": rv}

    def forward(self, x, z=None):
        return self._epilogue(super().forward(x), z)


GroupBatchNorm2d = BatchNorm2d_NHWC  # ≡ apex.contrib.cudnn_gbn
