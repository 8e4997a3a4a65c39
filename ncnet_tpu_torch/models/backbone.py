"""Feature-extraction trunks: ResNet-101 cut at layer3 (the reference
default), VGG-16 cut at pool4 (or any other unit by its reference name),
DenseNet-201 cut after transition2, and a ``tiny`` 2-conv trunk for tests.

Mirrors ``ncnet_tpu/models/backbone.py``: parameters are a plain dict of
tensors (conv weights in PyTorch's OIHW layout, BatchNorm as raw
``scale/bias/mean/var`` applied as an eval-mode affine with eps 1e-5), the
public functions take and return channels-last ``(B, H, W, C)`` tensors and
run ``F.conv2d``/``F.max_pool2d``/``F.avg_pool2d`` in NCHW inside (written
out by hand: the trunks need no torchvision).
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


# VGG-16 ``features`` through pool5: output channels per conv, -1 marks a
# 2×2 max pool.  The reference default cut is pool4 (model.py:24-35).
VGG16_PLAN = (
    64, 64, -1, 128, 128, -1, 256, 256, 256, -1,
    512, 512, 512, -1, 512, 512, 512, -1,
)

# DenseNet-201 under the reference cut (features[:-4]: conv0 to transition2
# inclusive, model.py:69-74): growth 32, bn_size 4; only the first two
# dense blocks fall inside the cut.
DENSENET201_BLOCKS = {"denseblock1": 6, "denseblock2": 12}
DENSENET_GROWTH = 32
DENSENET_BN_SIZE = 4

OUTPUT_CHANNELS = {"resnet101": 1024, "vgg": 512, "tiny": 32, "densenet201": 256}
OUTPUT_STRIDE = {"resnet101": 16, "vgg": 16, "tiny": 16, "densenet201": 16}


def _vgg_units(last_layer: str):
    """Unit ops (``('conv', i)``, ``('relu',)``, ``('pool',)``) up to the
    cut, inclusive.  Names follow the reference's vgg_feature_layers
    (model.py:26-31): ``convN_M``, ``reluN_M``, ``poolN``; '' means
    ``pool4``.  A cut at a conv name ends on the raw conv output (no
    trailing ReLU), as the reference's Sequential slice does."""
    last = last_layer or "pool4"
    units, names = [], []
    block, c, ci = 1, 0, 0
    for cout in VGG16_PLAN:
        if cout == -1:
            units.append(("pool",))
            names.append(f"pool{block}")
            block += 1
            c = 0
        else:
            c += 1
            units.append(("conv", ci))
            names.append(f"conv{block}_{c}")
            units.append(("relu",))
            names.append(f"relu{block}_{c}")
            ci += 1
    if last not in names:
        raise ValueError(f"unsupported vgg cut {last!r}; have {names}")
    return units[: names.index(last) + 1]


def _vgg_num_convs(last_layer: str) -> int:
    return sum(1 for u in _vgg_units(last_layer) if u[0] == "conv")


def _densenet_cut(last_layer: str) -> None:
    if last_layer not in ("", "transition2"):
        raise ValueError(
            f"unsupported densenet201 cut {last_layer!r}; only 'transition2'")


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


def init_vgg16(g: torch.Generator, dtype=torch.float32,
               last_layer: str = "") -> Dict[str, Any]:
    """Random-init VGG-16 features up to ``last_layer`` (convs carry
    biases, zero at init)."""
    convs = []
    cin = 3
    for cout in [c for c in VGG16_PLAN if c != -1][:_vgg_num_convs(last_layer)]:
        convs.append({"w": _he_conv(g, 3, 3, cin, cout, dtype),
                      "b": torch.zeros(cout, dtype=dtype)})
        cin = cout
    return {"convs": convs}


def init_densenet201(g: torch.Generator, dtype=torch.float32,
                     last_layer: str = "") -> Dict[str, Any]:
    """Random-init DenseNet-201 trunk (conv0 to transition2, torchvision
    layout); ``last_layer`` must be '' or ``'transition2'``, the only cut
    the reference offers (model.py:69-74)."""
    _densenet_cut(last_layer)
    params: Dict[str, Any] = {"conv0": {"w": _he_conv(g, 7, 7, 3, 64, dtype)},
                              "norm0": _bn_init(64, dtype)}
    c = 64
    mid = DENSENET_BN_SIZE * DENSENET_GROWTH
    for bi, (name, n_layers) in enumerate(DENSENET201_BLOCKS.items(), start=1):
        layers = []
        for _ in range(n_layers):
            layers.append({
                "norm1": _bn_init(c, dtype),
                "conv1": {"w": _he_conv(g, 1, 1, c, mid, dtype)},
                "norm2": _bn_init(mid, dtype),
                "conv2": {"w": _he_conv(g, 3, 3, mid, DENSENET_GROWTH, dtype)},
            })
            c += DENSENET_GROWTH
        params[name] = layers
        params[f"transition{bi}"] = {
            "norm": _bn_init(c, dtype),
            "conv": {"w": _he_conv(g, 1, 1, c, c // 2, dtype)}}
        c //= 2  # the transition conv halves the channels
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


def vgg16_features(params: Dict[str, Any], images: torch.Tensor,
                   last_layer: str = "") -> torch.Tensor:
    """``(B, H, W, 3)`` → ``(B, H/16, W/16, 512)`` at the default pool4 cut."""
    x = images.permute(0, 3, 1, 2)
    for unit in _vgg_units(last_layer):
        if unit[0] == "pool":
            x = F.max_pool2d(x, 2, 2)
        elif unit[0] == "conv":
            c = params["convs"][unit[1]]
            x = F.conv2d(x, c["w"], c["b"], padding=1)
        else:
            x = F.relu(x)
    return x.permute(0, 2, 3, 1).contiguous()


def densenet201_features(params: Dict[str, Any], images: torch.Tensor,
                         last_layer: str = "") -> torch.Tensor:
    """``(B, H, W, 3)`` → ``(B, H/16, W/16, 256)`` at the reference's
    transition2 cut: each dense layer concatenates its 32 new channels
    onto the running stack; a transition halves the channels and
    average-pools 2×2."""
    _densenet_cut(last_layer)
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(F.conv2d(x, params["conv0"]["w"], stride=2, padding=3),
                   params["norm0"]))
    x = F.max_pool2d(x, 3, 2, 1)
    for bi, name in enumerate(DENSENET201_BLOCKS, start=1):
        for layer in params[name]:
            y = F.conv2d(F.relu(_bn(x, layer["norm1"])), layer["conv1"]["w"])
            y = F.conv2d(F.relu(_bn(y, layer["norm2"])), layer["conv2"]["w"],
                         padding=1)
            x = torch.cat([x, y], dim=1)
        tr = params[f"transition{bi}"]
        x = F.avg_pool2d(F.conv2d(F.relu(_bn(x, tr["norm"])), tr["conv"]["w"]),
                         2, 2)
    return x.permute(0, 2, 3, 1).contiguous()


def tiny_features(params: Dict[str, Any], images: torch.Tensor,
                  last_layer: str = "") -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, params["conv1"]["w"], params["conv1"]["b"],
                        stride=4, padding=2))
    x = F.relu(F.conv2d(x, params["conv2"]["w"], params["conv2"]["b"],
                        stride=4, padding=2))
    return x.permute(0, 2, 3, 1).contiguous()


_INITS = {"resnet101": init_resnet101, "vgg": init_vgg16,
          "densenet201": init_densenet201, "tiny": init_tiny}
_APPLYS = {"resnet101": resnet101_features, "vgg": vgg16_features,
           "densenet201": densenet201_features, "tiny": tiny_features}


def _check_name(name: str) -> None:
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


def _vgg_conv_indices(last_layer: str):
    """Indices of the convs in torchvision's ``vgg16.features`` Sequential
    (conv, relu pairs and the pools) up to the cut: 0, 2, 5, 7, 10, ... ."""
    idx, out = 0, []
    for cout in VGG16_PLAN:
        if len(out) == _vgg_num_convs(last_layer):
            break
        if cout == -1:
            idx += 1  # the pool
        else:
            out.append(idx)
            idx += 2  # conv + relu
    return out


def import_torch_backbone(state_dict, name: str = "resnet101",
                          prefix: str = "", last_layer: str = ""):
    """A torchvision-named ``state_dict`` (values torch tensors or numpy
    arrays) → the trunk's parameter tree, the counterpart of
    ``ncnet_tpu/models/backbone.py:449``: ``resnet101`` (``conv1.weight``,
    ``bn1.*``, ``layer<n>.<i>.conv<j>.weight``, ...), ``vgg``
    (``vgg16.features`` with its prefix stripped: ``<i>.weight``,
    ``<i>.bias``) and ``densenet201`` (``densenet201.features`` stripped:
    ``conv0.weight``, ``denseblock<n>.denselayer<i>.norm1.*``, ...).  Conv
    weights keep PyTorch's OIHW layout (the port's own); ``prefix`` strips
    a leading path and skips keys without it.  Units past ``last_layer``
    are not read."""
    _check_name(name)
    sd = {k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)}
    if name == "vgg":
        return {"convs": [{"w": _t(sd[f"{i}.weight"]), "b": _t(sd[f"{i}.bias"])}
                          for i in _vgg_conv_indices(last_layer)]}
    if name == "densenet201":
        _densenet_cut(last_layer)
        params: Dict[str, Any] = {"conv0": {"w": _t(sd["conv0.weight"])},
                                  "norm0": _import_bn(sd, "norm0")}
        for bi, (bname, n_layers) in enumerate(DENSENET201_BLOCKS.items(),
                                               start=1):
            layers = []
            for i in range(1, n_layers + 1):
                p = f"{bname}.denselayer{i}"
                layers.append({
                    "norm1": _import_bn(sd, f"{p}.norm1"),
                    "conv1": {"w": _t(sd[f"{p}.conv1.weight"])},
                    "norm2": _import_bn(sd, f"{p}.norm2"),
                    "conv2": {"w": _t(sd[f"{p}.conv2.weight"])}})
            params[bname] = layers
            params[f"transition{bi}"] = {
                "norm": _import_bn(sd, f"transition{bi}.norm"),
                "conv": {"w": _t(sd[f"transition{bi}.conv.weight"])}}
        return params
    if name != "resnet101":
        raise ValueError(f"no torchvision state_dict exists for the {name!r} "
                         "trunk")
    params = {"conv1": {"w": _t(sd["conv1.weight"])},
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
    the last ``n_finetune_blocks`` units (conv weights and biases, BN
    affine; BN running stats never train): residual blocks of the ResNet,
    convs of the VGG, and for the DenseNet transition2 then denseblock2's
    layers from the deepest; for ``tiny``, the whole trunk."""
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
    if name == "vgg":
        for i in range(len(params["convs"]))[-n_finetune_blocks:]:
            labels["convs"][i] = unfreeze(params["convs"][i])
        return labels
    if name == "densenet201":
        # the reference's model[-1][-(i+1)] indexes sub-children of the last
        # Sequential child; the dense layer is the useful analog
        units = [("transition2", None)] + [
            ("denseblock2", i)
            for i in reversed(range(len(params["denseblock2"])))]
        for unit, i in units[:n_finetune_blocks]:
            if i is None:
                labels[unit] = unfreeze(params[unit])
            else:
                labels[unit][i] = unfreeze(params[unit][i])
        return labels
    return unfreeze(params)  # tiny: the whole (non-pretrained) trunk
