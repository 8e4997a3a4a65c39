"""Host-side input pipeline of the port: the weak-supervision pair and
PF-Pascal datasets in the raw image form (ROADMAP decision D1), the loader
and the synthetic fixtures."""

from ncnet_tpu_torch.data.datasets import (
    MAX_KEYPOINTS,
    ImagePairDataset,
    PFPascalDataset,
    SampleDecodeError,
    load_image,
)
from ncnet_tpu_torch.data.loader import DataLoader, default_collate

__all__ = [
    "DataLoader",
    "ImagePairDataset",
    "MAX_KEYPOINTS",
    "PFPascalDataset",
    "SampleDecodeError",
    "default_collate",
    "load_image",
]
