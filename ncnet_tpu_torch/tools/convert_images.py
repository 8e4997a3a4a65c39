"""Convert a dataset tree's JPEG images to the raw form the port reads
(ROADMAP decision D1).

Every ``<rel>.jpg`` (or ``.jpeg``, ``.png``) under the root gets
``<rel>.jpg.npy`` beside it: the image as PIL decodes it, grayscale
replicated to three channels and alpha dropped as the JAX loader does,
saved with ``np.save`` as an ``(H, W, 3)`` uint8 array.  Both packages then
see the same pixels bit for bit; CSVs and every other file stay as they
are.  PIL is needed only here, and is imported only when the tool runs.

    python -m ncnet_tpu_torch.tools.convert_images datasets/pf-pascal/

Existing raw files are kept unless ``--overwrite`` is given.  Prints one
summary line; exits 1 if an image could not be decoded.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np

from ncnet_tpu_torch.data.datasets import as_rgb, raw_path

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


def convert_tree(root: str, overwrite: bool = False) -> Dict[str, List[str]]:
    """Write the raw file of every image under ``root``; returns the paths
    ``{"written": [...], "kept": [...], "failed": [...]}``."""
    from PIL import Image

    out: Dict[str, List[str]] = {"written": [], "kept": [], "failed": []}
    for dirpath, _, names in sorted(os.walk(root)):
        for name in sorted(names):
            if not name.lower().endswith(IMAGE_SUFFIXES):
                continue
            path = os.path.join(dirpath, name)
            dest = raw_path(path)
            if os.path.exists(dest) and not overwrite:
                out["kept"].append(path)
                continue
            try:
                with Image.open(path) as im:
                    arr = as_rgb(np.asarray(im))
            except (OSError, ValueError):
                out["failed"].append(path)
                continue
            if arr.dtype != np.uint8:
                out["failed"].append(path)
                continue
            tmp = dest + ".tmp.npy"
            np.save(tmp, np.ascontiguousarray(arr))
            os.replace(tmp, dest)
            out["written"].append(path)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("root", help="dataset tree holding the images")
    p.add_argument("--overwrite", action="store_true",
                   help="rewrite raw files that already exist")
    args = p.parse_args(argv)
    res = convert_tree(args.root, overwrite=args.overwrite)
    print(f"convert_images: {len(res['written'])} written, "
          f"{len(res['kept'])} kept, {len(res['failed'])} failed"
          + (f": {res['failed']}" if res["failed"] else ""))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
