"""Megatron pretraining batch samplers (counterpart of
apex_tpu/transformer/_data/_batchsampler.py).

Iterate the global batch indices and yield this data-parallel rank's
slice: a sequential sampler and an epoch-shuffled one.  Plain Python
iterables, usable with any loader.  The random sampler's epoch shuffle
is `np.random.RandomState(epoch)`'s permutation, as in the JAX package,
so both packages yield the same index streams.
"""

from __future__ import annotations

import numpy as np


class MegatronPretrainingSampler:
    """Consecutive micro-batches of this dp rank, from
    `consumed_samples` on; a last partial batch only with
    `drop_last=False`."""

    def __init__(self, total_samples, consumed_samples, micro_batch_size,
                 data_parallel_rank, data_parallel_size,
                 drop_last: bool = True):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)
        self.drop_last = drop_last
        assert self.total_samples > 0
        assert self.consumed_samples < self.total_samples
        assert 0 <= data_parallel_rank < data_parallel_size

    def __len__(self):
        return self.total_samples

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.micro_batch_size
        return start, start + self.micro_batch_size

    def __iter__(self):
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_data_parallel_size:
                s, e = self.get_start_end_idx()
                yield batch[s:e]
                batch = []
        if len(batch) > 0 and not self.drop_last:
            s, e = self.get_start_end_idx()
            yield batch[s:e]


class MegatronPretrainingRandomSampler:
    """Epoch-seeded shuffle within this dp rank's bucket of the samples;
    resumes mid-epoch from `consumed_samples`."""

    def __init__(self, total_samples, consumed_samples, micro_batch_size,
                 data_parallel_rank, data_parallel_size):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)
        self.last_batch_size = (
            self.total_samples % self.micro_batch_times_data_parallel_size)
        assert self.total_samples > 0
        assert 0 <= data_parallel_rank < data_parallel_size

    def __len__(self):
        return self.total_samples

    def __iter__(self):
        active_total_samples = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples
        assert (current_epoch_samples %
                self.micro_batch_times_data_parallel_size == 0)

        bucket_size = (self.total_samples //
                       self.micro_batch_times_data_parallel_size) \
            * self.micro_batch_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        g = np.random.RandomState(self.epoch)
        random_idx = g.permutation(bucket_size).tolist()
        idx_range = [start_idx + x for x in random_idx[bucket_offset:]]

        batch = []
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.micro_batch_size:
                self.consumed_samples += (
                    self.micro_batch_times_data_parallel_size)
                yield batch
                batch = []
