"""Determinism helpers, the port of ``ncnet_tpu/utils/seeding.py``.

The reference seeds torch and numpy globally (``train.py:25-29``) and
vendors a DataLoader to get per-worker numpy seeding
(``lib/dataloader.py:39-43``).  The port keeps no module-global torch RNG:
code that draws takes an explicit ``torch.Generator``
(:func:`torch_generator`); the numpy helpers serve the host pipeline.
"""

from __future__ import annotations

import numpy as np
import torch


def global_seed(seed: int = 1) -> np.random.Generator:
    """Seed host-side numpy (the legacy global RNG the augmentations use)
    and return a fresh Generator for code that takes one explicitly."""
    np.random.seed(seed)
    return np.random.default_rng(seed)


def worker_rng(base_seed: int, worker_id: int) -> np.random.Generator:
    """An independent stream per data-loading worker
    (lib/dataloader.py:39-43)."""
    return np.random.default_rng(np.random.SeedSequence([base_seed, worker_id]))


def torch_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the CPU when None) seeded with
    ``seed``: the explicit generator the port's random draws take."""
    g = torch.Generator(device=device if device is not None else "cpu")
    return g.manual_seed(int(seed))
