"""Host-side datasets, the port of ``ncnet_tpu/data/datasets.py``:
``SampleDecodeError``, ``load_image``, ``load_image_with_retry``,
``_preprocess``, ``_parse_points``, the weak-supervision
``ImagePairDataset`` and the PF-Pascal keypoint ``PFPascalDataset``.

Images are read in their raw form (ROADMAP decision D1): each image
``<rel>.jpg`` of a dataset tree has ``<rel>.jpg.npy`` beside it, an
``(H, W, 3)`` uint8 array saved with ``np.save``
(``tools/convert_images.py`` writes them from a JPEG tree with PIL, so these
datasets see PIL's pixels bit for bit, as the JAX package's do).  The pair
CSVs are read with the ``csv`` module.  Same preprocessing order as the
reference (grayscale to 3 channels, random crop, flip, record the image
size, THEN resize; optional ImageNet normalization), the same −1 keypoint
padding to 20 and the 'pf' / 'scnet' PCK procedures, channels-last numpy
out, and a seeded per-``(seed, epoch, idx)`` generator for the crops.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ncnet_tpu_torch.ops.image import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    resize_bilinear_align_corners_np,
)
from ncnet_tpu_torch.utils import faults

MAX_KEYPOINTS = 20  # reference pads keypoint arrays to 20 (pf_dataset.py:106-108)
RAW_SUFFIX = ".npy"  # D1: <rel>.jpg is read as <rel>.jpg.npy


class SampleDecodeError(RuntimeError):
    """A sample's image could not be read after all retries.  Carries the
    offending ``path`` so the loader's quarantine policy can log and skip
    exactly that file (``data/loader.py``)."""

    def __init__(self, path: str, cause: Exception):
        super().__init__(f"failed to decode {path!r}: {cause}")
        self.path = path


def raw_path(path: str) -> str:
    """The raw array file that stands for the image at ``path``."""
    return path + RAW_SUFFIX


def as_rgb(arr: np.ndarray) -> np.ndarray:
    """A decoded image as ``(H, W, 3)``: grayscale replicated to 3
    channels (im_pair_dataset.py:64-65), alpha dropped, as the JAX
    loader does to PIL's array."""
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] > 3:
        arr = arr[:, :, :3]
    return arr


def load_image(path: str) -> np.ndarray:
    """The ``(H, W, 3)`` uint8 image at ``path``, read from its raw file
    (:func:`raw_path`)."""
    path = raw_path(path)
    faults.decode_hook(path)  # no-op unless a test armed an injected fault
    arr = np.load(path, allow_pickle=False)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
        raise ValueError(f"{path!r} holds {arr.dtype} {arr.shape}, not an "
                         "(H, W, 3) uint8 image")
    return as_rgb(arr)


def load_image_with_retry(path: str, retries: int) -> np.ndarray:
    """:func:`load_image` with bounded transient-error retry, raising
    :class:`SampleDecodeError` (which carries the raw file's path for
    quarantine) after the budget."""
    err: Optional[Exception] = None
    for _ in range(max(retries, 0) + 1):
        try:
            return load_image(path)
        except Exception as e:  # np.load raises OSError/ValueError variants
            err = e
    raise SampleDecodeError(raw_path(path), err)


def normalize_imagenet_np(image: np.ndarray) -> np.ndarray:
    """The host ImageNet normalization of the JAX data path, in float32:
    ``(image / 255 − mean) / std``."""
    mean = np.asarray(IMAGENET_MEAN, dtype=np.float32)
    std = np.asarray(IMAGENET_STD, dtype=np.float32)
    return ((image / 255.0 - mean) / std).astype(np.float32)


def _preprocess(image: np.ndarray, out_h: int, out_w: int, normalize: bool
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Record the (h, w, c) size, then resize; optional ImageNet
    normalization (the reference's NormalizeImageDict transform)."""
    im_size = np.asarray(image.shape, dtype=np.float32)
    image = resize_bilinear_align_corners_np(image.astype(np.float32), out_h,
                                             out_w)
    if normalize:
        image = normalize_imagenet_np(image)
    return image, im_size


def _read_csv_rows(path: str):
    """The data rows of a CSV (the header row names the columns)."""
    with open(path, newline="") as f:
        return list(csv.reader(f))[1:]


class ImagePairDataset:
    """Weak-supervision pairs from a ``source,target,class,flip`` CSV
    (im_pair_dataset.py:26-57).

    ``decode_retries``: transient read errors are retried that many times
    per image; a sample that still fails raises :class:`SampleDecodeError`,
    which the loader's quarantine policy can absorb."""

    def __init__(
        self,
        dataset_csv_path: str,
        dataset_csv_file: str,
        dataset_image_path: str,
        dataset_size: int = 0,
        output_size: Tuple[int, int] = (240, 240),
        normalize: bool = True,
        random_crop: bool = False,
        seed: int = 1,
        decode_retries: int = 1,
    ):
        self.out_h, self.out_w = output_size
        self.random_crop = random_crop
        self.normalize = normalize
        self.decode_retries = decode_retries
        rows = _read_csv_rows(os.path.join(dataset_csv_path, dataset_csv_file))
        if dataset_size:
            rows = rows[: min(dataset_size, len(rows))]
        self.img_a_names = [r[0] for r in rows]
        self.img_b_names = [r[1] for r in rows]
        self.set = np.asarray([int(r[2]) for r in rows], dtype=np.int64)
        self.flip = np.asarray([int(r[3]) for r in rows], dtype=np.int64)
        self.image_path = dataset_image_path
        self.seed = seed
        self.epoch = 0  # set via set_epoch (DataLoader does this per epoch)

    def set_epoch(self, epoch: int) -> None:
        """Vary augmentation draws across epochs while staying
        deterministic (the reference's per-worker reseeding,
        lib/dataloader.py:39-43)."""
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.img_a_names)

    def _get_image(self, name: str, flip: int, rng
                   ) -> Tuple[np.ndarray, np.ndarray]:
        image = load_image_with_retry(os.path.join(self.image_path, name),
                                      self.decode_retries)
        if self.random_crop:
            # crop bounds exactly as the reference draws them
            # (im_pair_dataset.py:68-74)
            h, w, _ = image.shape
            top = int(rng.integers(h // 4))
            bottom = int(3 * h / 4 + rng.integers(h // 4))
            left = int(rng.integers(w // 4))
            right = int(3 * w / 4 + rng.integers(w // 4))
            image = image[top:bottom, left:right]
        if flip:
            image = image[:, ::-1]
        return _preprocess(image, self.out_h, self.out_w, self.normalize)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # per-(seed, epoch, sample) generator: deterministic under any
        # thread scheduling (a shared Generator is not thread-safe)
        rng = np.random.default_rng([self.seed, self.epoch, idx])
        flip = self.flip[idx]
        image_a, size_a = self._get_image(self.img_a_names[idx], flip, rng)
        image_b, size_b = self._get_image(self.img_b_names[idx], flip, rng)
        return {
            "source_image": image_a,
            "target_image": image_b,
            "source_im_size": size_a,
            "target_im_size": size_b,
            "set": self.set[idx],
        }


def _parse_points(x_str: str, y_str: str) -> np.ndarray:
    """';'-separated keypoint strings → (2, 20) with −1 padding
    (pf_dataset.py:104-108)."""
    def parse(s):
        return np.asarray([float(v) for v in s.split(";") if v.strip()])

    x, y = parse(x_str), parse(y_str)
    pts = -np.ones((2, MAX_KEYPOINTS), dtype=np.float32)
    pts[0, : len(x)] = x
    pts[1, : len(x)] = y
    return pts


class PFPascalDataset:
    """PF-Pascal keypoint-annotated pairs (pf_dataset.py:26-113).

    CSV columns: source, target, class, XA;YA strings, XB;YB strings.
    ``pck_procedure``: 'pf' (L_pck = max bbox side of valid A points) or
    'scnet' (points rescaled to 224×224, L_pck = 224).
    """

    def __init__(
        self,
        csv_file: str,
        dataset_path: str,
        output_size: Tuple[int, int] = (240, 240),
        normalize: bool = True,
        category: Optional[int] = None,
        pck_procedure: str = "pf",
        decode_retries: int = 1,
    ):
        self.out_h, self.out_w = output_size
        self.normalize = normalize
        self.pck_procedure = pck_procedure
        self.decode_retries = decode_retries
        rows = _read_csv_rows(csv_file)
        self.category = np.asarray([float(r[2]) for r in rows],
                                   dtype=np.float32)
        if category is not None:
            keep = np.nonzero(self.category == category)[0]
            self.category = self.category[keep]
            rows = [rows[i] for i in keep]
        self.img_a_names = [r[0] for r in rows]
        self.img_b_names = [r[1] for r in rows]
        self.point_a = [(r[3], r[4]) for r in rows]
        self.point_b = [(r[5], r[6]) for r in rows]
        self.dataset_path = dataset_path

    def __len__(self) -> int:
        return len(self.img_a_names)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # SampleDecodeError-wrapped (with bounded transient retry) so the
        # loader's quarantine policy can isolate a corrupt eval image
        image_a = load_image_with_retry(
            os.path.join(self.dataset_path, self.img_a_names[idx]),
            self.decode_retries)
        image_b = load_image_with_retry(
            os.path.join(self.dataset_path, self.img_b_names[idx]),
            self.decode_retries)
        image_a, size_a = _preprocess(image_a, self.out_h, self.out_w,
                                      self.normalize)
        image_b, size_b = _preprocess(image_b, self.out_h, self.out_w,
                                      self.normalize)

        pts_a = _parse_points(*self.point_a[idx])
        pts_b = _parse_points(*self.point_b[idx])
        n_pts = int(np.sum(pts_a[0] != -1))

        if self.pck_procedure == "pf":
            valid = pts_a[:, :n_pts]
            l_pck = np.asarray(
                [np.max(valid.max(axis=1) - valid.min(axis=1))],
                dtype=np.float32)
        elif self.pck_procedure == "scnet":
            # SCNet evaluation: rescale everything to a virtual 224×224
            # image (pf_dataset.py:64-75)
            pts_a[0, :n_pts] *= 224 / size_a[1]
            pts_a[1, :n_pts] *= 224 / size_a[0]
            pts_b[0, :n_pts] *= 224 / size_b[1]
            pts_b[1, :n_pts] *= 224 / size_b[0]
            size_a = np.asarray([224, 224, 3], dtype=np.float32)
            size_b = np.asarray([224, 224, 3], dtype=np.float32)
            l_pck = np.asarray([224.0], dtype=np.float32)
        else:
            raise ValueError(f"unknown pck_procedure {self.pck_procedure!r}")

        return {
            "source_image": image_a,
            "target_image": image_b,
            "source_im_size": size_a,
            "target_im_size": size_b,
            "source_points": pts_a,
            "target_points": pts_b,
            "L_pck": l_pck,
        }
