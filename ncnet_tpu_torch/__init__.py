"""ncnet_tpu_torch: the PyTorch + CUDA port of ``ncnet_tpu`` for NVIDIA H100.

Mirrors the JAX package's module paths and function names.  It imports
``torch`` and ``numpy`` only, never JAX or the JAX package.  Entry points
(``models.NCNet``, ``models.make_point_matcher``,
``serving.engine.BatchMatchEngine``, ``serving.MatchService``) run on the
card unless the caller passes ``device="cpu"`` (``devices=`` for the
service).
"""
