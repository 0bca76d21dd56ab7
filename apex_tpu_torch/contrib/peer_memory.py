"""Peer-memory halo exchange facade (counterpart of
apex_tpu/contrib/peer_memory.py, itself ≡ apex.contrib.peer_memory's
PeerMemoryPool and PeerHaloExchanger1d).  The reference moves halos
through raw CUDA IPC buffers over NVLink; here they go through NCCL
point-to-point (`parallel.collectives.halo_exchange_1d`), which uses
NVLink between the cards of a host, so the pool keeps no memory."""

from __future__ import annotations

from apex_tpu_torch.parallel.collectives import halo_exchange_1d


class PeerMemoryPool:
    """≡ PeerMemoryPool (peer_memory.py:5-60): kept for the API; NCCL
    owns the transfer buffers, so there is nothing to pool, and raw peer
    tensors raise."""

    def __init__(self, static_size: int = 0, dynamic_size: int = 0,
                 peer_ranks=None):
        self.peer_ranks = peer_ranks

    def allocate_peer_tensors(self, shape, dtype, channels_last, dynamic):
        raise NotImplementedError(
            "raw peer-memory tensors are not kept: halos go through NCCL "
            "point-to-point (see PeerHaloExchanger1d)")

    def reset(self):
        pass


class PeerHaloExchanger1d:
    """≡ PeerHaloExchanger1d (peer_halo_exchanger_1d.py:5): the 1-D halo
    exchange along a sharded spatial dim, over the group of `axis_name`
    (the mesh's)."""

    def __init__(self, ranks=None, rank_in_group=None, peer_pool=None,
                 half_halo: int = 1, axis_name: str = "dp"):
        self.half_halo = half_halo
        self.axis_name = axis_name

    def __call__(self, y, H_split: bool = True, explicit_nhwc: bool = True,
                 numSM: int = 0, diagnostics: bool = False):
        """(left, right): the previous rank's last and the next rank's
        first `half_halo` rows of `y` along H (dim 1) or W (dim 2)."""
        return halo_exchange_1d(y, self.axis_name, self.half_halo,
                                dim=1 if H_split else 2)
