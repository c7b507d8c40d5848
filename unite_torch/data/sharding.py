"""Index sharding with repetitions (length-matching dual streams), copied
from unite_tpu/data/sharding.py.

The reference's repetition-aware DistributedSampler
(distributed.py:33-163) length-matches the source and target streams in
stages 1/3 (run_stage1.py:711-752): the shorter stream gets
``repetitions = ceil(len_long / len_short)`` independent shuffles
concatenated, indices are padded (or tail-dropped) to a multiple of the
shard count, then strided by shard id. The port runs one process on one
card (one shard) until scale-out lands (ROADMAP slice E).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np


class ShardedSampler:
    def __init__(
        self,
        dataset_len: int,
        num_shards: int,
        shard_id: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        repetitions: int = 1,
    ):
        assert 0 <= shard_id < num_shards
        self.dataset_len = dataset_len
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.repetitions = repetitions
        self.epoch = 0

        total = dataset_len * repetitions
        if drop_last and total % num_shards != 0:
            self.num_samples = math.ceil((total - num_shards) / num_shards)
        else:
            self.num_samples = math.ceil(total / num_shards)
        self.total_size = self.num_samples * num_shards

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> List[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            parts = [
                rng.permutation(self.dataset_len) for _ in range(self.repetitions)
            ]
            indices = np.concatenate(parts).tolist()
        else:
            indices = list(range(self.dataset_len)) * self.repetitions

        if not self.drop_last:
            pad = self.total_size - len(indices)
            if pad > 0:
                if pad <= len(indices):
                    indices += indices[:pad]
                else:
                    indices += (indices * math.ceil(pad / len(indices)))[:pad]
        else:
            indices = indices[: self.total_size]
        assert len(indices) == self.total_size

        shard = indices[self.shard_id : self.total_size : self.num_shards]
        assert len(shard) == self.num_samples
        return shard

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples


def repetitions_to_match(short_len: int, long_len: int) -> int:
    """ceil(long/short): repetitions for the shorter stream
    (run_stage1.py:713-752 length-matching)."""
    return max(1, math.ceil(long_len / max(short_len, 1)))
