"""The PF-Pascal eval step, the port of ``ncnet_tpu/evaluation/pf_pascal.py``
(``RESULT_COLUMNS``, ``make_eval_step``).

One step per batch: forward → softmax match extraction → keypoint warp →
PCK, with the pair's quality signals beside it, so one fetched ``(B, 6)``
table carries labels and label-free signals together.  Any batch size
works: every PF-Pascal eval image is resized to the same square.  The eval
loop itself (the loader, the pipelined fetch, the journal) is not ported
yet: its images are decoded on the host, and the card has no decoder.
"""

from __future__ import annotations

from typing import Dict

import torch

from ncnet_tpu_torch.evaluation.pck import pck_metric
from ncnet_tpu_torch.models.ncnet import ncnet_forward
from ncnet_tpu_torch.observability.quality import QUALITY_SIGNALS, quality_table
from ncnet_tpu_torch.ops.image import normalize_imagenet
from ncnet_tpu_torch.ops.matching import corr_to_matches

# per-batch result columns: per-pair PCK, then the quality signals
RESULT_COLUMNS = ("pck",) + QUALITY_SIGNALS


def make_eval_step(net, alpha: float, device_normalize: bool = False):
    """``step(params, batch)`` → the per-sample ``(B, 6)`` float32 table:
    PCK in column 0, the quality signals
    (:data:`~ncnet_tpu_torch.observability.quality.QUALITY_SIGNALS`) in the
    rest, over the same filtered volume the match extraction reads.

    ``net`` is the port's :class:`~ncnet_tpu_torch.models.ncnet.NCNet`;
    ``params`` its ``net.params`` (or another tree of the same shape on its
    device), ``batch`` a dict of tensors on that device (the keys of
    :func:`~ncnet_tpu_torch.evaluation.pck.pck_metric` and
    ``source_image``/``target_image``).  ``device_normalize``: the images
    arrive as resized uint8 and the ImageNet normalization runs on the
    device (cast to bf16 under ``backbone_bf16``); otherwise they are
    normalized floats.  The step runs under ``torch.no_grad`` inside a
    ``torch.profiler.record_function("pf_pascal_eval_step")`` range."""
    config = net.config

    @torch.no_grad()
    def step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.profiler.record_function("pf_pascal_eval_step"):
            src, tgt = batch["source_image"], batch["target_image"]
            if device_normalize:
                src, tgt = normalize_imagenet(src), normalize_imagenet(tgt)
                if config.backbone_bf16:
                    src = src.to(torch.bfloat16)
                    tgt = tgt.to(torch.bfloat16)
            out = ncnet_forward(config, params, src, tgt)
            matches = corr_to_matches(out.corr, do_softmax=True)
            scores = pck_metric(batch, matches, alpha)
            return torch.cat([scores.to(torch.float32)[:, None],
                              quality_table(out.corr)], dim=1)

    return step
