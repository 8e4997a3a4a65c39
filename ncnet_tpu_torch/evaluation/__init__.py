"""Metrics and evaluation of the port: PCK, the PF-Pascal eval step and
loop, and the InLoc match table (the InLoc loop comes in a later slice)."""

from ncnet_tpu_torch.evaluation.inloc import extract_match_table
from ncnet_tpu_torch.evaluation.pck import pck, pck_metric
from ncnet_tpu_torch.evaluation.pf_pascal import make_eval_step, run_eval

__all__ = [
    "extract_match_table",
    "make_eval_step",
    "pck",
    "pck_metric",
    "run_eval",
]
