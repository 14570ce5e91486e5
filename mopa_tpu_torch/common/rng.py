"""Seeding of the host random generators (port of
``mopa_tpu/common/rng.py``; the JAX package's ``make_key`` has no
counterpart: the port's device randomness is a ``torch.Generator`` in the
train state)."""

import random

import numpy as np
import torch


def set_random_seed(seed):
    """Seed ``random``, numpy's global state and torch. None or a negative
    seed leaves them time-seeded, as the reference's -1 does."""
    if seed is None or seed < 0:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def worker_rng(seed, worker_id):
    """A numpy Generator of its own per data worker."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & 0x7FFFFFFF, worker_id]))
