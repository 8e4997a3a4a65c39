"""Profiler annotations, the part of ``ncnet_tpu/utils/profiling.py`` the
eval path calls: :func:`annotate`.  The step-window tracer and
``maybe_trace`` come with the training loop (ROADMAP A6)."""

from __future__ import annotations

import torch


def annotate(name: str):
    """Named range in the profiler's trace (cheap; always on): a
    ``torch.profiler.record_function`` context."""
    return torch.profiler.record_function(name)
