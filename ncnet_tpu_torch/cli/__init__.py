"""Command-line entry points of the port (``python -m
ncnet_tpu_torch.cli.<name>``), with the JAX package's flags."""
