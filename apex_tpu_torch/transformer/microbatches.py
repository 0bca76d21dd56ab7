"""Microbatch calculators (counterpart of
apex_tpu/transformer/microbatches.py:12-103, itself ≡
apex/transformer/microbatches.py:26-175): ConstantNumMicroBatches and
RampupBatchsizeNumMicroBatches — pure host-side bookkeeping, the JAX
package's semantics and messages.
"""

from __future__ import annotations

from typing import Optional


def build_num_microbatches_calculator(
        rank: int, rampup_batch_size: Optional[list],
        global_batch_size: int, micro_batch_size: int,
        data_parallel_size: int):
    """≡ microbatches.build_num_microbatches_calculator (26-77)."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size)
    start, incr, samples = map(int, rampup_batch_size[:3])
    return RampupBatchsizeNumMicroBatches(
        start, incr, samples, global_batch_size, micro_batch_size,
        data_parallel_size)


class ConstantNumMicroBatches:
    """≡ microbatches.ConstantNumMicroBatches (89-116)."""

    def __init__(self, global_batch_size, micro_batch_size,
                 data_parallel_size):
        micro_batch_times_dp = micro_batch_size * data_parallel_size
        assert global_batch_size % micro_batch_times_dp == 0, (
            f"global batch size ({global_batch_size}) is not divisible by "
            f"micro batch size ({micro_batch_size}) times data parallel "
            f"size ({data_parallel_size})")
        self.num_micro_batches = global_batch_size // micro_batch_times_dp
        assert self.num_micro_batches >= 1
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def get(self):
        return self.num_micro_batches

    def get_current_global_batch_size(self):
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches:
    """≡ microbatches.RampupBatchsizeNumMicroBatches (119-175): linear
    batch-size rampup over consumed samples."""

    def __init__(self, start_batch_size, batch_size_increment,
                 ramup_samples, global_batch_size, micro_batch_size,
                 data_parallel_size):
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)
        assert self.micro_batch_times_data_parallel_size > 0
        assert start_batch_size > 0
        self.start_batch_size = start_batch_size
        assert global_batch_size > 0
        self.global_batch_size = global_batch_size
        diff_batch_size = global_batch_size - start_batch_size
        assert diff_batch_size >= 0
        assert batch_size_increment > 0
        self.batch_size_increment = batch_size_increment
        assert diff_batch_size % batch_size_increment == 0, (
            "expected global batch size interval to be divisible by global "
            "batch size increment")
        num_increments = diff_batch_size // batch_size_increment
        self.ramup_samples = ramup_samples
        assert self.ramup_samples >= 0
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments else 0)
        self.num_micro_batches = None
        self.current_global_batch_size = None
        self.update(0, False)

    def get(self):
        return self.num_micro_batches

    def get_current_global_batch_size(self):
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check):
        if consumed_samples > self.ramup_samples:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment)
            self.current_global_batch_size = min(
                self.current_global_batch_size, self.global_batch_size)
        if consistency_check:
            assert (self.current_global_batch_size %
                    self.micro_batch_times_data_parallel_size == 0)
        self.num_micro_batches = max(
            1, self.current_global_batch_size //
            self.micro_batch_times_data_parallel_size)
