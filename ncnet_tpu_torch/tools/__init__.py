"""Probe tools of the port (the JAX package's ``tools/`` counterparts).

Each module runs from the repository root as a script on the card:

    python3 -m ncnet_tpu_torch.tools.pallas_l2_probe 8 bf16
    python3 -m ncnet_tpu_torch.tools.mosaic_probes [name ...]
    python3 -m ncnet_tpu_torch.tools.l2_variants [name ...]

``pallas_l2_probe`` times the L2 layer's CUDA kernel in the padded
fused-lane frame; ``mosaic_probes`` builds and checks a battery of minimal
``sm_90a`` kernels, one Hopper primitive each; ``l2_variants`` times the
L2 kernel's design choices (its compile-time constants) against each
other.  They keep the JAX tools'
names so that a reader finds the counterpart, but they are CUDA: they run
on the card unless given ``device="cpu"`` (the tests), where only the plain
twins run.
"""
