"""Point-transfer demo, the port of the root ``point_transfer_demo.py``:
the reference notebook as a headless script.

Loads a checkpoint (or a random model of ``--backbone``), runs one
PF-Pascal pair through the warm point matcher (``models.make_point_matcher``),
transfers the annotated keypoints from target to source via
``corr_to_matches`` + ``bilinear_interp_point_tnf``, and writes the points
and their PCK@0.1 as JSON — the smoke test of the whole inference path
(reference: point_transfer_demo.ipynb cells 3, 5, 7):

    python -m ncnet_tpu_torch.cli.point_transfer_demo \
        --eval_dataset_path datasets/pf-pascal/ --checkpoint ncnet_pfpascal.pth.tar \
        --out demo.png [--device cuda|cpu]

Without a dataset on disk, ``--synthetic`` fabricates a shifted pair with
known ground truth so the demo runs hermetically.  The model runs on
``--device``: CUDA unless ``cpu`` is named; without a GPU it raises.  The
JSON goes to ``--json`` (default: ``--out`` with a ``.json`` suffix); the
side-by-side figure goes to ``--out`` where matplotlib is installed, and
otherwise a warning names the figure that was not drawn.  The dataset's
images are read in their raw form (ROADMAP decision D1: ``--synthetic``
writes them so; ``tools/convert_images.py`` converts a JPEG tree).
"""

from __future__ import annotations

import argparse
import json
import os

PCK_ALPHA = 0.1  # the threshold as a fraction of L_pck, as the eval's


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="NCNet point transfer demo")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--eval_dataset_path", type=str, default="datasets/pf-pascal/")
    p.add_argument("--image_size", type=int, default=400)
    p.add_argument("--pair_idx", type=int, default=0)
    p.add_argument("--backbone", type=str, default="resnet101",
                   help="used only when no checkpoint is given")
    p.add_argument("--synthetic", action="store_true",
                   help="fabricate a synthetic shifted pair (no dataset needed)")
    p.add_argument("--out", type=str, default="point_transfer_demo.png")
    p.add_argument("--json", type=str, default="",
                   help="where the points and their PCK go (default: --out "
                        "with a .json suffix)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs (default cuda)")
    return p


def transfer(args) -> dict:
    """The demo's numbers: the target keypoints, their transfer into the
    source image and the source ground truth (original pixel frames), the
    mean transfer error and the PCK."""
    import numpy as np
    import torch

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.data import PFPascalDataset
    from ncnet_tpu_torch.evaluation.pck import pck
    from ncnet_tpu_torch.models import NCNet, make_point_matcher
    from ncnet_tpu_torch.models.ncnet import resolve_device
    from ncnet_tpu_torch.ops.image import quantize_u8
    from ncnet_tpu_torch.ops.matching import (
        Matches,
        bilinear_interp_point_tnf,
        points_to_pixel_coords,
        points_to_unit_coords,
    )

    dev = resolve_device(args.device)
    if args.synthetic:
        import tempfile

        from ncnet_tpu_torch.data.synthetic import write_pf_pascal_like

        root = tempfile.mkdtemp()
        write_pf_pascal_like(root, n_pairs=1, image_hw=(args.image_size,) * 2,
                             shift=(args.image_size // 8,) * 2)
        args.eval_dataset_path = root

    net = NCNet(ModelConfig(backbone=args.backbone, checkpoint=args.checkpoint),
                device=dev)
    dataset = PFPascalDataset(
        csv_file=os.path.join(args.eval_dataset_path, "image_pairs",
                              "test_pairs.csv"),
        dataset_path=args.eval_dataset_path,
        output_size=(args.image_size, args.image_size),
        pck_procedure="pf",
        # the warm matcher normalizes on the device: the demo uploads the
        # raw resized uint8 pixels
        normalize=False,
    )
    sample = dataset[args.pair_idx]
    src_u8 = quantize_u8(sample["source_image"])[None]
    tgt_u8 = quantize_u8(sample["target_image"])[None]

    matcher = make_point_matcher(net.config, net.params, do_softmax=True,
                                 device=dev)
    matches = Matches(*(torch.from_numpy(np.asarray(v))
                        for v in matcher(src_u8, tgt_u8)))

    tgt_pts = torch.as_tensor(np.asarray(sample["target_points"]))[None]
    src_pts = torch.as_tensor(np.asarray(sample["source_points"]))[None]
    tgt_size = torch.as_tensor(np.asarray(sample["target_im_size"]))[None]
    src_size = torch.as_tensor(np.asarray(sample["source_im_size"]))[None]
    n_valid = int((tgt_pts[0, 0] != -1).sum())

    warped_norm = bilinear_interp_point_tnf(
        matches, points_to_unit_coords(tgt_pts, tgt_size))
    warped = points_to_pixel_coords(warped_norm, src_size)
    l_pck = torch.as_tensor(np.asarray(sample["L_pck"]))[None]
    score = float(pck(src_pts.to(warped.dtype), warped, l_pck, PCK_ALPHA)[0])
    err = np.linalg.norm(warped[0, :, :n_valid].numpy()
                         - src_pts[0, :, :n_valid].numpy(), axis=0)
    return {
        "pair_idx": args.pair_idx,
        "image_size": args.image_size,
        "device": str(dev),
        "n_valid": n_valid,
        "target_points": tgt_pts[0, :, :n_valid].tolist(),
        "transferred_points": warped[0, :, :n_valid].tolist(),
        "source_points": src_pts[0, :, :n_valid].tolist(),
        "source_im_size": src_size[0].tolist(),
        "target_im_size": tgt_size[0].tolist(),
        "mean_error_px": float(err.mean()) if n_valid else None,
        "alpha": PCK_ALPHA,
        "pck": score,
        "images": (src_u8[0], tgt_u8[0]),
    }


def draw(out: dict, path: str) -> bool:
    """The side-by-side figure (target keypoints; transferred points beside
    the source ground truth) at ``path``; False where matplotlib is not
    installed."""
    import numpy as np

    from ncnet_tpu_torch.utils.plot import pyplot

    plt = pyplot(f"the figure {path}")
    if plt is None:
        return False
    side = out["image_size"]

    def to_disp(pts, size):
        # dataset points are in ORIGINAL pixel space; images are shown at
        # the resized square
        pts = np.asarray(pts, dtype=np.float64)
        return pts * np.array([[side / float(size[1])],
                               [side / float(size[0])]])

    n = out["n_valid"]
    warped_d = to_disp(out["transferred_points"], out["source_im_size"])
    srcgt_d = to_disp(out["source_points"], out["source_im_size"])
    tgt_d = to_disp(out["target_points"], out["target_im_size"])
    src_img, tgt_img = out["images"]
    fig, (ax_s, ax_t) = plt.subplots(1, 2, figsize=(10, 5))
    for ax, img in ((ax_s, src_img), (ax_t, tgt_img)):
        ax.imshow(img)
        ax.set_axis_off()
    colors = plt.cm.tab20(np.linspace(0, 1, max(n, 1)))
    if n:
        ax_t.scatter(tgt_d[0], tgt_d[1], c=colors[:n], s=40,
                     edgecolors="white", label="target keypoints")
        ax_s.scatter(warped_d[0], warped_d[1], c=colors[:n], s=40,
                     marker="o", edgecolors="white", label="transferred")
        ax_s.scatter(srcgt_d[0], srcgt_d[1], s=70, facecolors="none",
                     edgecolors=colors[:n], marker="s", label="ground truth")
    ax_s.set_title("source: transferred (o) vs GT (□)")
    ax_t.set_title("target: annotated keypoints")
    fig.suptitle(f"mean transfer error: {out['mean_error_px'] or 0.0:.1f} px "
                 f"({n} keypoints), PCK@{out['alpha']:g} {out['pck']:.3f}")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = transfer(args)
    json_path = args.json or os.path.splitext(args.out)[0] + ".json"
    with open(json_path, "w") as f:
        json.dump({k: v for k, v in out.items() if k != "images"}, f,
                  indent=2, sort_keys=True)
    drew = draw(out, args.out)
    print(f"wrote {json_path}" + (f" and {args.out}" if drew else "")
          + f"  (mean error {out['mean_error_px'] or 0.0:.2f} px, "
          f"PCK@{PCK_ALPHA:g} {out['pck']:.4f}, {out['n_valid']} keypoints)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
