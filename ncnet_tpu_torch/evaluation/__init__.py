"""Metrics and evaluation of the port: PCK, the PF-Pascal eval step and
loop, and the InLoc matching loop."""

from ncnet_tpu_torch.evaluation.inloc import (
    extract_match_table,
    make_pair_matcher,
    run_inloc_eval,
)
from ncnet_tpu_torch.evaluation.pck import pck, pck_metric
from ncnet_tpu_torch.evaluation.pf_pascal import make_eval_step, run_eval

__all__ = [
    "extract_match_table",
    "make_eval_step",
    "make_pair_matcher",
    "pck",
    "pck_metric",
    "run_eval",
    "run_inloc_eval",
]
