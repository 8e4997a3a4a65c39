"""Shared CLI helpers, the port of ``ncnet_tpu/cli/common.py``."""

from __future__ import annotations

import argparse


def str_to_bool(v: str) -> bool:
    """Boolean flag parser, reference lib/torch_util.py:64-70 semantics."""
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")
