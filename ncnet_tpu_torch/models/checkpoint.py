"""Checkpoint import: the reference's ``.pth.tar`` pickles, the part of
``ncnet_tpu/models/checkpoint.py`` that an eval with published weights
needs (``split_reference_state_dict``, ``import_torch_checkpoint``,
``load_params``), and the trunk's torchvision ``state_dict``
(``ModelConfig.backbone_weights``, :func:`load_backbone_weights`).

A reference checkpoint is ``{epoch, args, state_dict, ...}``
(reference train.py:197-205).  The importer mirrors the reference's own
load-time quirks: the ``'vgg'→'model'`` key rename and the architecture
override from the stored ``args`` (model.py:211-232); ``num_batches_tracked``
buffers are ignored (model.py:244-248).  The JAX package's native
checkpoint directories (orbax) and versioned training roots come with the
training loop (ROADMAP A6); :func:`load_params` refuses them.

:func:`reference_state_dict` goes the other way, from the port's
parameters to the reference's key names and layouts, so the port's weights
can be written as a ``.pth.tar`` the reference (and this importer) reads.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.config import ModelConfig
from ncnet_tpu_torch.models import backbone as bb

# the reference's FeatureExtraction wraps the trunk in nn.Sequential, so
# resnet children are addressed by index (model.py:38-44): 0=conv1 1=bn1
# 2=relu 3=maxpool 4=layer1 5=layer2 6=layer3 (7=layer4 for checkpoints
# trained with feature_extraction_last_layer='layer4')
_RESNET_SEQ_TO_NAME = {"0": "conv1", "1": "bn1", "4": "layer1",
                       "5": "layer2", "6": "layer3", "7": "layer4"}
_RESNET_NAME_TO_SEQ = {v: k for k, v in _RESNET_SEQ_TO_NAME.items()}


def _to_np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def split_reference_state_dict(state_dict, config: ModelConfig):
    """Rekey and split a reference ``state_dict``: the ``'vgg'→'model'``
    rename and the ``num_batches_tracked`` filter, then

      * ``fe_sd``: trunk weights keyed by torchvision names (numpy), and
      * ``nc_raw``: per-NC-layer ``(weight, bias)`` numpy pairs in the
        stored Conv4d layout ``(kA, C_out, C_in, kWA, kB, kWB)``."""
    sd = {k.replace("vgg", "model"): _to_np(v) for k, v in state_dict.items()}
    fe_sd = {}
    for k, v in sd.items():
        if not k.startswith("FeatureExtraction.model."):
            continue
        rest = k[len("FeatureExtraction.model."):]
        if "num_batches_tracked" in rest:
            continue
        if config.backbone == "resnet101":
            idx, _, tail = rest.partition(".")
            name = _RESNET_SEQ_TO_NAME.get(idx)
            if name is None:
                raise KeyError(f"unexpected trunk child index {idx} in {k}")
            fe_sd[f"{name}.{tail}"] = v
        else:
            fe_sd[rest] = v
    # Sequential [Conv4d, ReLU]×N → conv layers at indices 0, 2, 4, ...
    nc_raw = [
        (sd[f"NeighConsensus.conv.{2 * j}.weight"],
         sd[f"NeighConsensus.conv.{2 * j}.bias"])
        for j in range(len(config.ncons_kernel_sizes))
    ]
    return fe_sd, nc_raw


def import_torch_checkpoint(ckpt: Any,
                            base_config: ModelConfig = ModelConfig()
                            ) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Convert a reference ``.pth.tar`` checkpoint (a path or the loaded
    dict) into ``(config, params)``: the architecture fields overridden
    from the stored ``args``, as the reference does; the trunk through
    :func:`~ncnet_tpu_torch.models.backbone.import_torch_backbone` and the
    NC weights moved from ``(kA, C_out, C_in, kWA, kB, kWB)`` to the
    port's ``(k, k, k, k, C_in, C_out)`` (CPU tensors)."""
    if isinstance(ckpt, (str, os.PathLike)):
        # the pickle holds the reference's argparse Namespace
        ckpt = torch.load(ckpt, map_location="cpu", weights_only=False)

    config = base_config
    args = ckpt.get("args")
    if args is not None:
        config = config.replace(
            ncons_kernel_sizes=tuple(getattr(args, "ncons_kernel_sizes",
                                             config.ncons_kernel_sizes)),
            ncons_channels=tuple(getattr(args, "ncons_channels",
                                         config.ncons_channels)),
        )
        fe = getattr(args, "feature_extraction_cnn", None)
        if fe:
            config = config.replace(backbone=fe)
        fe_last = getattr(args, "feature_extraction_last_layer", None)
        if fe_last:
            config = config.replace(backbone_last_layer=fe_last)

    fe_sd, nc_raw = split_reference_state_dict(ckpt["state_dict"], config)
    backbone = bb.import_torch_backbone(fe_sd, config.backbone,
                                        last_layer=config.backbone_last_layer)
    nc = [{"w": torch.from_numpy(
               np.ascontiguousarray(np.transpose(w, (0, 3, 4, 5, 2, 1)))),
           "b": torch.from_numpy(np.array(b, copy=True))}
          for w, b in nc_raw]
    return config, {"backbone": backbone, "nc": nc}


def load_params(path: str, base_config: ModelConfig = ModelConfig()):
    """``(config, params)`` from a reference ``.pth.tar`` file at ``path``.
    A directory (the JAX package's native checkpoint, or a versioned
    training root) is not read yet: it comes with the training loop,
    ROADMAP A6."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path!r} is a checkpoint directory (the native format of the "
            "training loop); ncnet_tpu_torch reads it from ROADMAP A6 on — "
            "pass a reference .pth.tar file")
    return import_torch_checkpoint(path, base_config)


def load_backbone_weights(path: str, config: ModelConfig):
    """The trunk's parameters from a torchvision ``state_dict`` file
    (``ModelConfig.backbone_weights``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return bb.import_torch_backbone(sd, config.backbone,
                                    last_layer=config.backbone_last_layer)


def reference_state_dict(config: ModelConfig, params) -> Dict[str, torch.Tensor]:
    """The port's ResNet-101 parameters under the reference's
    ``ImMatchNet`` key names and layouts, the inverse of
    :func:`import_torch_checkpoint` (BatchNorm ``num_batches_tracked``
    buffers set to 0).  Save it as ``{"state_dict": ..., "args": ...}``
    with ``torch.save`` to write a reference checkpoint."""
    if config.backbone != "resnet101":
        raise ValueError(f"the reference layout of a {config.backbone!r} "
                         "trunk is not written by the port")
    sd: Dict[str, torch.Tensor] = {}

    def put(key, t):
        sd[key] = t.detach().to("cpu", torch.float32).clone()

    def put_bn(prefix, p):
        for name, leaf in (("weight", "scale"), ("bias", "bias"),
                           ("running_mean", "mean"), ("running_var", "var")):
            put(f"{prefix}.{name}", p[leaf])
        sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    trunk = params["backbone"]
    root = "FeatureExtraction.model"
    put(f"{root}.0.weight", trunk["conv1"]["w"])
    put_bn(f"{root}.1", trunk["bn1"])
    for stage in bb._resnet_stages(config.backbone_last_layer):
        seq = _RESNET_NAME_TO_SEQ[stage]
        for i, blk in enumerate(trunk[stage]):
            p = f"{root}.{seq}.{i}"
            for j in (1, 2, 3):
                put(f"{p}.conv{j}.weight", blk[f"conv{j}"]["w"])
                put_bn(f"{p}.bn{j}", blk[f"bn{j}"])
            if "downsample" in blk:
                put(f"{p}.downsample.0.weight", blk["downsample"]["conv"]["w"])
                put_bn(f"{p}.downsample.1", blk["downsample"]["bn"])
    for j, layer in enumerate(params["nc"]):
        put(f"NeighConsensus.conv.{2 * j}.weight",
            layer["w"].permute(0, 5, 4, 1, 2, 3))
        put(f"NeighConsensus.conv.{2 * j}.bias", layer["b"])
    return sd
