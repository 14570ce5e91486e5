"""Iteration-based batch sampling (port of
``mopa_tpu/common/sampler.py::IterationBasedBatchSampler``).

Yields exactly ``num_iterations`` batches of indices, resuming mid-stream at
``start_iter`` and looping a seeded permutation epoch after epoch; the same
seed gives the JAX package's index stream.
"""

import numpy as np


class IterationBasedBatchSampler:
    """Epoch loop over shuffled indices, cut to [start_iter, num_iterations)."""

    def __init__(self, dataset_size, batch_size, num_iterations, start_iter=0,
                 shuffle=True, drop_last=True, seed=0):
        self.dataset_size = int(dataset_size)
        self.batch_size = int(batch_size)
        self.num_iterations = int(num_iterations)
        self.start_iter = int(start_iter)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = int(seed)

    def _epoch_batches(self, epoch):
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch]))
            order = rng.permutation(self.dataset_size)
        else:
            order = np.arange(self.dataset_size)
        n_full = self.dataset_size // self.batch_size
        end = n_full * self.batch_size if self.drop_last else self.dataset_size
        for s in range(0, end, self.batch_size):
            yield order[s: s + self.batch_size]

    def __iter__(self):
        iteration = 0
        epoch = 0
        while iteration < self.num_iterations:
            for batch in self._epoch_batches(epoch):
                if iteration >= self.num_iterations:
                    return
                if iteration >= self.start_iter:
                    yield batch
                iteration += 1
            epoch += 1

    def __len__(self):
        return self.num_iterations - self.start_iter
