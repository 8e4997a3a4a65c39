"""Metrics and evaluation of the port: PCK, the PF-Pascal eval step and
the InLoc match table (the eval loops come in a later slice)."""

from ncnet_tpu_torch.evaluation.inloc import extract_match_table
from ncnet_tpu_torch.evaluation.pck import pck, pck_metric
from ncnet_tpu_torch.evaluation.pf_pascal import make_eval_step

__all__ = [
    "extract_match_table",
    "make_eval_step",
    "pck",
    "pck_metric",
]
