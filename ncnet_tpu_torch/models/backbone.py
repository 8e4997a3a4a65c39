"""Feature-extraction trunks: ResNet-101 cut at layer3 (the reference
default) and a ``tiny`` 2-conv trunk for tests.

Mirrors ``ncnet_tpu/models/backbone.py``: parameters are a plain dict of
tensors (conv weights in PyTorch's OIHW layout, BatchNorm as raw
``scale/bias/mean/var`` applied as an eval-mode affine with eps 1e-5), the
public functions take and return channels-last ``(B, H, W, C)`` tensors and
run ``F.conv2d`` in NCHW inside.  VGG-16 and DenseNet-201 come in a later
slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5

RESNET101_STAGES = {"layer1": 3, "layer2": 4, "layer3": 23, "layer4": 3}
RESNET101_PLANES = {"layer1": 64, "layer2": 128, "layer3": 256, "layer4": 512}


def _resnet_stages(last_layer: str):
    """Stages up to the cut point; '' means the reference default 'layer3'."""
    last = last_layer or "layer3"
    if last not in RESNET101_STAGES:
        raise ValueError(
            f"unsupported resnet101 cut {last!r}; have {list(RESNET101_STAGES)}")
    names = list(RESNET101_STAGES)
    return names[: names.index(last) + 1]


# ---------------------------------------------------------------------------
# primitives (NCHW inside)
# ---------------------------------------------------------------------------


def _bn(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eval-mode batch norm from stored running stats, as the folded affine
    ``x·inv + (bias − mean·inv)`` with ``inv = scale·rsqrt(var + eps)``."""
    inv = p["scale"] * torch.rsqrt(p["var"] + BN_EPS)
    shift = p["bias"] - p["mean"] * inv
    return x * inv[None, :, None, None] + shift[None, :, None, None]


def _bottleneck(x, blk, stride):
    """torchvision Bottleneck (stride on the 3×3 conv)."""
    out = F.relu(_bn(F.conv2d(x, blk["conv1"]["w"]), blk["bn1"]))
    out = F.relu(_bn(F.conv2d(out, blk["conv2"]["w"], stride=stride,
                              padding=1), blk["bn2"]))
    out = _bn(F.conv2d(out, blk["conv3"]["w"]), blk["bn3"])
    if "downsample" in blk:
        x = _bn(F.conv2d(x, blk["downsample"]["conv"]["w"], stride=stride),
                blk["downsample"]["bn"])
    return F.relu(out + x)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _he_conv(g: torch.Generator, kh, kw, cin, cout, dtype):
    std = math.sqrt(2.0 / (kh * kw * cout))
    return torch.randn((cout, cin, kh, kw), generator=g, dtype=dtype) * std


def _bn_init(c, dtype):
    return {"scale": torch.ones(c, dtype=dtype),
            "bias": torch.zeros(c, dtype=dtype),
            "mean": torch.zeros(c, dtype=dtype),
            "var": torch.ones(c, dtype=dtype)}


def init_resnet101(g: torch.Generator, dtype=torch.float32,
                   last_layer: str = "") -> Dict[str, Any]:
    """Random-init ResNet-101 trunk (conv1..``last_layer``)."""
    params: Dict[str, Any] = {
        "conv1": {"w": _he_conv(g, 7, 7, 3, 64, dtype)},
        "bn1": _bn_init(64, dtype),
    }
    inplanes = 64
    for stage in _resnet_stages(last_layer):
        planes = RESNET101_PLANES[stage]
        blocks = []
        for i in range(RESNET101_STAGES[stage]):
            blk = {
                "conv1": {"w": _he_conv(g, 1, 1, inplanes, planes, dtype)},
                "bn1": _bn_init(planes, dtype),
                "conv2": {"w": _he_conv(g, 3, 3, planes, planes, dtype)},
                "bn2": _bn_init(planes, dtype),
                "conv3": {"w": _he_conv(g, 1, 1, planes, planes * 4, dtype)},
                "bn3": _bn_init(planes * 4, dtype),
            }
            if i == 0:
                blk["downsample"] = {
                    "conv": {"w": _he_conv(g, 1, 1, inplanes, planes * 4,
                                           dtype)},
                    "bn": _bn_init(planes * 4, dtype),
                }
                inplanes = planes * 4
            blocks.append(blk)
        params[stage] = blocks
    return params


def init_tiny(g: torch.Generator, dtype=torch.float32,
              last_layer: str = "") -> Dict[str, Any]:
    """Tiny 2-conv stride-16 trunk for tests (no reference analog)."""
    return {
        "conv1": {"w": _he_conv(g, 5, 5, 3, 16, dtype),
                  "b": torch.zeros(16, dtype=dtype)},
        "conv2": {"w": _he_conv(g, 5, 5, 16, 32, dtype),
                  "b": torch.zeros(32, dtype=dtype)},
    }


# ---------------------------------------------------------------------------
# forward passes: (B, H, W, 3) -> (B, H/16, W/16, C)
# ---------------------------------------------------------------------------


def resnet101_features(params: Dict[str, Any], images: torch.Tensor,
                       last_layer: str = "") -> torch.Tensor:
    """``(B, H, W, 3)`` → ``(B, H/16, W/16, 1024)`` at the default layer3 cut."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(F.conv2d(x, params["conv1"]["w"], stride=2, padding=3),
                   params["bn1"]))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage in _resnet_stages(last_layer):
        stride = 1 if stage == "layer1" else 2
        for i, blk in enumerate(params[stage]):
            x = _bottleneck(x, blk, stride if i == 0 else 1)
    return x.permute(0, 2, 3, 1).contiguous()


def tiny_features(params: Dict[str, Any], images: torch.Tensor,
                  last_layer: str = "") -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, params["conv1"]["w"], params["conv1"]["b"],
                        stride=4, padding=2))
    x = F.relu(F.conv2d(x, params["conv2"]["w"], params["conv2"]["b"],
                        stride=4, padding=2))
    return x.permute(0, 2, 3, 1).contiguous()


_INITS = {"resnet101": init_resnet101, "tiny": init_tiny}
_APPLYS = {"resnet101": resnet101_features, "tiny": tiny_features}


def _check_name(name: str) -> None:
    if name in ("vgg", "densenet201"):
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (resnet101 and tiny are)")
    if name not in _APPLYS:
        raise ValueError(f"unknown backbone {name!r}; have {sorted(_APPLYS)}")


def backbone_init(name: str, generator: torch.Generator,
                  dtype=torch.float32, last_layer: str = ""):
    _check_name(name)
    return _INITS[name](generator, dtype, last_layer)


def backbone_apply(name: str, params, images: torch.Tensor,
                   last_layer: str = "") -> torch.Tensor:
    _check_name(name)
    return _APPLYS[name](params, images, last_layer)


# ---------------------------------------------------------------------------
# torchvision state_dict import
# ---------------------------------------------------------------------------


def _t(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().clone()
    return torch.from_numpy(np.array(v, copy=True))


def _import_bn(sd, prefix) -> Dict[str, torch.Tensor]:
    return {"scale": _t(sd[prefix + ".weight"]),
            "bias": _t(sd[prefix + ".bias"]),
            "mean": _t(sd[prefix + ".running_mean"]),
            "var": _t(sd[prefix + ".running_var"])}


def import_torch_backbone(state_dict, name: str = "resnet101",
                          prefix: str = "", last_layer: str = ""):
    """A torchvision-named ``state_dict`` (``resnet101``: ``conv1.weight``,
    ``bn1.*``, ``layer<n>.<i>.conv<j>.weight``, ...; values torch tensors
    or numpy arrays) → the trunk's parameter tree, the counterpart of
    ``ncnet_tpu/models/backbone.py:449``.  Conv weights keep PyTorch's
    OIHW layout (the port's own); ``prefix`` strips a leading path and
    skips keys without it.  Stages past ``last_layer`` are not read."""
    _check_name(name)
    if name != "resnet101":
        raise ValueError(f"no torchvision state_dict exists for the {name!r} "
                         "trunk")
    sd = {k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)}
    params: Dict[str, Any] = {"conv1": {"w": _t(sd["conv1.weight"])},
                              "bn1": _import_bn(sd, "bn1")}
    for stage in _resnet_stages(last_layer):
        blocks = []
        for i in range(RESNET101_STAGES[stage]):
            p = f"{stage}.{i}"
            blk = {f"{part}{j}": ({"w": _t(sd[f"{p}.conv{j}.weight"])}
                                  if part == "conv"
                                  else _import_bn(sd, f"{p}.bn{j}"))
                   for j in (1, 2, 3) for part in ("conv", "bn")}
            if f"{p}.downsample.0.weight" in sd:
                blk["downsample"] = {
                    "conv": {"w": _t(sd[f"{p}.downsample.0.weight"])},
                    "bn": _import_bn(sd, f"{p}.downsample.1")}
            blocks.append(blk)
        params[stage] = blocks
    return params


# ---------------------------------------------------------------------------
# fine-tune partition (reference train.py:60-63 semantics)
# ---------------------------------------------------------------------------


def _label_tree(node, label_of, key=None):
    if isinstance(node, dict):
        return {k: _label_tree(v, label_of, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_label_tree(v, label_of, key) for v in node]
    return label_of(key)


def finetune_labels(name: str, params, n_finetune_blocks: int):
    """The params tree with a ``'frozen'`` or ``'trainable'`` label at
    every leaf (``ncnet_tpu/models/backbone.py:377``): all frozen, except
    the last ``n_finetune_blocks`` residual blocks of the ResNet (conv
    weights and BN affine; BN running stats never train) or, for ``tiny``,
    the whole trunk."""
    _check_name(name)

    def unfreeze(subtree):
        return _label_tree(subtree, lambda key: "frozen"
                           if key in ("mean", "var") else "trainable")

    labels = _label_tree(params, lambda key: "frozen")
    if n_finetune_blocks <= 0:
        return labels
    if name == "resnet101":
        blocks = [(s, i) for s in RESNET101_STAGES if s in params
                  for i in range(len(params[s]))]
        for s, i in blocks[-n_finetune_blocks:]:
            labels[s][i] = unfreeze(params[s][i])
        return labels
    return unfreeze(params)  # tiny: the whole (non-pretrained) trunk
