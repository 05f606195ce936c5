"""Seeding (counterpart of ``vargp_tpu/utils/prng.py``; the reference's
train_utils.py:13-18 set_seeds).

The JAX drivers split one key per task from the run's key.  Here a task's
``torch.Generator`` is derived from the run's seed and the task's index
alone (``task_generator``), so a resumed run draws for task t exactly
what an uninterrupted one draws.
"""

import random

import numpy as np
import torch


def seed_everything(seed: int | None):
    """Seed ``random`` and numpy; return (root, seed), ``root`` the
    ``numpy.random.SeedSequence`` the per-task generators come from.
    None picks a seed and prints it (the reference leaves its generators
    unseeded then)."""
    if seed is None:
        seed = random.SystemRandom().randrange(2**31)
        print(f"seed_everything: seed={seed}")
    random.seed(seed)
    np.random.seed(seed)
    return np.random.SeedSequence(seed), seed


def task_generator(root: np.random.SeedSequence, task_id: int, device) -> torch.Generator:
    """Task ``task_id``'s generator on ``device``, seeded from
    (root's seed, task_id) only."""
    child = np.random.SeedSequence(root.entropy, spawn_key=(*root.spawn_key, task_id))
    (state,) = child.generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state) >> 1)
