"""The device mesh, the port of ``ncnet_tpu/parallel/mesh.py``.

JAX lays its devices out as a ``jax.sharding.Mesh`` with two logical axes,
``data`` (image pairs) and ``spatial`` (the hB dim of the correlation
volume), and lets XLA insert the collectives.  The port keeps the grid and
its axis names but drives it by hand, one process over the devices of its
own host (ROADMAP D7): ``parallel/spatial.py`` splits the volume over the
``spatial`` axis and moves the halos between devices itself.  Data
parallelism across processes is ``torch.distributed``'s
(``parallel/distributed.py``), not this grid's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


class Mesh:
    """A ``(data, spatial)`` grid of ``torch.device`` s of this process.
    ``devices[d, s]`` holds pair group ``d``'s hB shard ``s``; ``shape``
    maps each axis name to its size, as a JAX mesh's does."""

    axis_names = (DATA_AXIS, SPATIAL_AXIS)

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def row(self, d: int):
        """The devices of pair group ``d``, hB shard by shard."""
        return list(self.devices[d])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def make_mesh(data: Optional[int] = None, spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over ``devices`` (default: every CUDA device of this process,
    each once), ``spatial`` the minor axis.  ``data=None`` uses every
    device not consumed by ``spatial``.  Raises when there are fewer
    devices than the grid needs.  An explicit ``devices`` list may name
    one device more than once: the shards then share it, which runs the
    sharded logic at full size on one card (or on the CPU in tests)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if data is None:
        if not devices or len(devices) % spatial:
            raise ValueError(
                f"{len(devices)} devices not divisible by spatial={spatial}")
        data = len(devices) // spatial
    n = data * spatial
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}"
                         + ("" if devices else " (no CUDA device visible)"))
    grid = np.empty((data, spatial), dtype=object)
    for i, dev in enumerate(devices[:n]):
        grid[i // spatial, i % spatial] = dev
    return Mesh(grid)
