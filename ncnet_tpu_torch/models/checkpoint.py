"""Checkpoint I/O, the port of ``ncnet_tpu/models/checkpoint.py``: the
reference's ``.pth.tar`` importer, the port's native checkpoint directories
and the versioned training roots ``fit`` writes, and the trunk's
torchvision ``state_dict`` (``ModelConfig.backbone_weights``,
:func:`load_backbone_weights`).

A reference checkpoint is ``{epoch, args, state_dict, ...}``
(reference train.py:197-205).  The importer mirrors the reference's own
load-time quirks: the ``'vgg'→'model'`` key rename and the architecture
override from the stored ``args`` (model.py:211-232); ``num_batches_tracked``
buffers are ignored (model.py:244-248).  :func:`reference_state_dict` goes
the other way, from the port's parameters to the reference's key names and
layouts, so the port's weights can be written as a ``.pth.tar``.

Native format (ROADMAP decision D5).  A directory holds ``config.json``
(the :class:`ModelConfig` fields, then for a training version ``_train``,
``_epoch``, ``_step``, ``_position``, ``_train_loss``/``_test_loss`` and
``_payload_sha256``: the JAX package's keys, key for key) and the weights
as ``params/params.pt``, a ``torch.save`` of the parameter tree of CPU
tensors, read back with ``torch.load(..., weights_only=True)``; a training
version adds ``opt/opt.pt`` (``training/train.py``).  The JAX package
writes ``params/`` with orbax, which needs tensorstore: the port refuses
such a directory with an error that names the format.

Versioned training roots: ``fit`` writes a root holding ``step_<N>``
versions, each a complete native checkpoint.  A version is written to
``step_<N>.tmp`` and committed by one rename, so a ``step_<N>`` directory
with a ``config.json`` IS the completeness marker; ``.tmp`` carcasses are
skipped, and a ``step_<N>.old`` (the displaced original of a same-step
re-save whose replacement never committed) stands in for its version.
:func:`resolve_checkpoint_dir` maps a root, a version, a ``best_`` copy or a
flat checkpoint onto the directory to read, so every loader accepts any of
them.

:func:`params_payload_sha256` is the JAX package's digest for the same
weights: leaves in ``jax.tree.leaves`` order (dict keys sorted) and in the
JAX layout (trunk convs HWIO), so a model's identity does not depend on
which package wrote it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.config import ModelConfig
from ncnet_tpu_torch.models import backbone as bb
from ncnet_tpu_torch.models.ncnet import tree_map

# fields that describe the trained network (restored from checkpoints); all
# other ModelConfig fields are runtime flags owned by the caller
_ARCH_FIELDS = (
    "backbone",
    "backbone_last_layer",
    "ncons_kernel_sizes",
    "ncons_channels",
    "symmetric_mode",
    "normalize_features",
)
# D5: the tensor payload of a native checkpoint directory
PARAMS_FILE = os.path.join("params", "params.pt")

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


def load_backbone_weights(path: str, config: ModelConfig):
    """The trunk's parameters from a torchvision ``state_dict`` file
    (``ModelConfig.backbone_weights``).  A whole ``vgg16`` or
    ``densenet201`` state dict nests the trunk under ``features.``, which
    is stripped (``ncnet_tpu/models/ncnet.py:295``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if config.backbone in ("vgg", "densenet201") and any(
            k.startswith("features.") for k in sd):
        sd = {k[len("features."):]: v for k, v in sd.items()
              if k.startswith("features.")}
    return bb.import_torch_backbone(sd, config.backbone,
                                    last_layer=config.backbone_last_layer)


def reference_state_dict(config: ModelConfig, params) -> Dict[str, torch.Tensor]:
    """The port's parameters under the reference's ``ImMatchNet`` key names
    and layouts, the inverse of :func:`import_torch_checkpoint` (BatchNorm
    ``num_batches_tracked`` buffers set to 0): ResNet-101 children by
    their Sequential index, VGG-16 convs by their index in
    ``vgg16.features``, DenseNet-201 under its torchvision names.  Save it
    as ``{"state_dict": ..., "args": ...}`` with ``torch.save`` to write a
    reference checkpoint."""
    if config.backbone not in ("resnet101", "vgg", "densenet201"):
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
    if config.backbone == "vgg":
        for i, conv in zip(bb._vgg_conv_indices(config.backbone_last_layer),
                           trunk["convs"]):
            put(f"{root}.{i}.weight", conv["w"])
            put(f"{root}.{i}.bias", conv["b"])
    elif config.backbone == "densenet201":
        put(f"{root}.conv0.weight", trunk["conv0"]["w"])
        put_bn(f"{root}.norm0", trunk["norm0"])
        for bi, bname in enumerate(bb.DENSENET201_BLOCKS, start=1):
            for i, layer in enumerate(trunk[bname], start=1):
                p = f"{root}.{bname}.denselayer{i}"
                for j in (1, 2):
                    put_bn(f"{p}.norm{j}", layer[f"norm{j}"])
                    put(f"{p}.conv{j}.weight", layer[f"conv{j}"]["w"])
            put_bn(f"{root}.transition{bi}.norm", trunk[f"transition{bi}"]["norm"])
            put(f"{root}.transition{bi}.conv.weight",
                trunk[f"transition{bi}"]["conv"]["w"])
    else:
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
                    put(f"{p}.downsample.0.weight",
                        blk["downsample"]["conv"]["w"])
                    put_bn(f"{p}.downsample.1", blk["downsample"]["bn"])
    for j, layer in enumerate(params["nc"]):
        put(f"NeighConsensus.conv.{2 * j}.weight",
            layer["w"].permute(0, 5, 4, 1, 2, 3))
        put(f"NeighConsensus.conv.{2 * j}.bias", layer["b"])
    return sd


# ---------------------------------------------------------------------------
# versioned checkpoint roots (atomic step_<N> layout; see the module docstring)
# ---------------------------------------------------------------------------

_VERSION_RE = re.compile(r"^step_(\d+)$")


def checkpoint_version_name(step: int) -> str:
    """``step_<N>`` zero-padded so lexicographic order == numeric order."""
    return f"step_{step:08d}"


def list_checkpoint_versions(root: str) -> List[Tuple[int, str]]:
    """Complete ``step_<N>`` versions under ``root``, ascending by step.

    Complete = no ``.tmp`` suffix (the rename is the commit) and a
    ``config.json`` inside.  A ``step_<N>.old`` stands in for version N
    when ``step_<N>`` is absent (a crash between a same-step re-save's two
    renames): it is a previously committed version.  ``[]`` when ``root``
    is not a directory or holds no versions."""
    if not os.path.isdir(root):
        return []
    out, displaced = {}, {}
    for name in os.listdir(root):
        base, old = (name[:-4], True) if name.endswith(".old") else (name, False)
        m = _VERSION_RE.match(base)
        path = os.path.join(root, name)
        if not (m and os.path.isdir(path)
                and os.path.isfile(os.path.join(path, "config.json"))):
            continue
        (displaced if old else out)[int(m.group(1))] = path
    for n, path in displaced.items():
        out.setdefault(n, path)  # recovered only when step_<N> is absent
    return sorted(out.items())


def resolve_checkpoint_dir(path: str) -> str:
    """The directory to read for ``path``: a versioned root's newest
    complete version, else ``path`` itself (a version, a ``best_`` copy, a
    flat checkpoint).  Raises if ``path`` holds only ``.tmp`` carcasses."""
    path = os.path.abspath(path)
    versions = list_checkpoint_versions(path)
    if versions:
        return versions[-1][1]
    if os.path.isdir(path) and not os.path.isfile(
            os.path.join(path, "config.json")):
        if any(n.endswith(".tmp") and _VERSION_RE.match(n[:-4])
               for n in os.listdir(path)):
            raise FileNotFoundError(
                f"checkpoint root {path!r} holds only incomplete .tmp "
                "versions (every save crashed mid-write); nothing to load")
    return path


def owning_checkpoint_root(path: str) -> Optional[str]:
    """The versioned root that owns ``path`` (a root, or a version inside
    one), or None: ``fit`` resumed from its own output keeps writing
    versions into that root."""
    path = os.path.abspath(path)
    if list_checkpoint_versions(path):
        return path
    base = os.path.basename(path)
    if base.endswith(".old"):  # a crash-recovered displaced version
        base = base[:-4]
    if _VERSION_RE.match(base):
        parent = os.path.dirname(path)
        if list_checkpoint_versions(parent):
            return parent
    return None


def with_io_retries(fn: Callable[[], Any], attempts: int = 3,
                    backoff: float = 0.5, what: str = "checkpoint I/O") -> Any:
    """``fn()`` with bounded retry and exponential backoff, for transient
    filesystem failures.  Each retry logs a warning and emits an
    ``io_retry`` event; the last failure raises.  In a process group of
    more than one rank there is one attempt: a rank retrying alone would
    fall out of step with the others, so the job-level restart is the
    retry (``ncnet_tpu/models/checkpoint.py:240``)."""
    from ncnet_tpu_torch.parallel import distributed as pdist

    if pdist.world_size() > 1:
        attempts = 1
    last: Optional[Exception] = None
    for i in range(max(attempts, 1)):
        try:
            return fn()
        except OSError as e:
            last = e
            if i + 1 < max(attempts, 1):
                delay = backoff * (2 ** i)
                from ncnet_tpu_torch.observability import events as obs_events
                from ncnet_tpu_torch.observability import get_logger

                get_logger("checkpoint").warning(
                    f"[fault-tolerance] {what} failed (attempt {i + 1}/"
                    f"{attempts}): {e}; retrying in {delay:.1f}s", kind="io")
                obs_events.emit("io_retry", what=what, attempt=i + 1,
                                attempts=attempts, error=str(e)[:300])
                time.sleep(delay)
    raise last  # type: ignore[misc]


# ---------------------------------------------------------------------------
# payload integrity
# ---------------------------------------------------------------------------

# config.json key carrying the params payload's digest; underscore-prefixed
# like the _train/_epoch keys, so load_params (which reads _ARCH_FIELDS only)
# skips it
PAYLOAD_SHA_KEY = "_payload_sha256"
# numpy's dtype string of ml_dtypes' bfloat16, the JAX package's bf16 leaves
_BF16_DTYPE_STR = "<V2"


class CheckpointPayloadError(RuntimeError):
    """Loaded params do not hash to the sha256 recorded at commit: bit rot,
    a torn copy or tampering.  Resume refuses the checkpoint."""


def _jax_leaves(tree, in_trunk: bool = False, key: Optional[str] = None):
    """``(leaf, in_trunk, key)`` in ``jax.tree.leaves`` order: dict keys
    sorted, list items in order, None dropped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], in_trunk or k == "backbone", k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _jax_leaves(v, in_trunk, key)
    elif tree is not None:
        yield tree, in_trunk, key


def _jax_array(leaf, in_trunk: bool, key: Optional[str]):
    """``(dtype string, numpy array)`` of a leaf as the JAX package holds
    it: trunk conv weights back to HWIO, bf16 as its raw 16-bit words under
    ml_dtypes' dtype string."""
    t = leaf.detach().cpu() if torch.is_tensor(leaf) else torch.as_tensor(leaf)
    if in_trunk and key == "w" and t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    if t.dtype == torch.bfloat16:
        return _BF16_DTYPE_STR, np.ascontiguousarray(t.view(torch.int16).numpy())
    a = np.ascontiguousarray(t.numpy())
    return a.dtype.str, a


def params_payload_sha256(params) -> str:
    """sha256 over every param leaf's dtype string, shape and bytes, in the
    JAX package's leaf order and layout (see the module docstring): the
    JAX package's ``params_payload_sha256`` of the same weights."""
    h = hashlib.sha256()
    for leaf, in_trunk, key in _jax_leaves(params):
        dtype, a = _jax_array(leaf, in_trunk, key)
        h.update(dtype.encode())
        h.update(str(tuple(a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def verify_checkpoint_payload(path: str, params) -> Optional[str]:
    """Check loaded ``params`` against the sha256 the checkpoint's
    ``config.json`` recorded: the verified digest, or None when the
    checkpoint records none.  Raises :class:`CheckpointPayloadError` on a
    mismatch."""
    cfg_path = os.path.join(resolve_checkpoint_dir(path), "config.json")
    try:
        with open(cfg_path) as f:
            expect = json.load(f).get(PAYLOAD_SHA_KEY)
    except (OSError, ValueError):
        return None
    if not expect:
        return None
    got = params_payload_sha256(params)
    if got != expect:
        raise CheckpointPayloadError(
            f"checkpoint {path!r} payload sha256 mismatch: config.json "
            f"records {expect[:16]}..., loaded params hash to {got[:16]}... "
            "— refusing the corrupt/torn payload")
    return got


# ---------------------------------------------------------------------------
# native checkpoints (D5)
# ---------------------------------------------------------------------------


def cpu_tree(tree):
    """``tree`` with every tensor detached and copied to the CPU (None
    leaves kept): what ``torch.save`` writes."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def write_config_json(path: str, doc: Dict[str, Any]) -> None:
    """``config.json`` as the JAX package writes it."""
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(doc, f, indent=2, default=list)


def save_tree(path: str, tree) -> None:
    """``torch.save`` of a tree of CPU tensors, its directory made first."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(tree, path)


def load_tree(directory: str, rel: str):
    """A payload tree written by :func:`save_tree` under ``directory``;
    a JAX (orbax) payload directory is refused by name."""
    path = os.path.join(directory, rel)
    if not os.path.isfile(path) and os.path.isdir(os.path.dirname(path)):
        raise ValueError(
            f"{os.path.dirname(path)!r} holds no {os.path.basename(path)}: "
            "it is the JAX package's orbax format, which ncnet_tpu_torch "
            "does not read (ROADMAP D5); re-save the weights with the port's "
            "save_params")
    return torch.load(path, map_location="cpu", weights_only=True)


def save_params(path: str, config: ModelConfig, params) -> None:
    """``{config.json, params/params.pt}`` under ``path``; ``config.json``
    records the payload sha256 (:func:`verify_checkpoint_payload`)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    params = cpu_tree(params)
    doc = dataclasses.asdict(config)
    doc[PAYLOAD_SHA_KEY] = params_payload_sha256(params)
    write_config_json(path, doc)
    save_tree(os.path.join(path, PARAMS_FILE), params)


def load_params(path: str, base_config: ModelConfig = ModelConfig()):
    """``(config, params)`` (CPU tensors) from a reference ``.pth.tar``
    file, a native directory written by :func:`save_params`, or a
    versioned training root or version written by ``fit`` (its newest
    complete version, :func:`resolve_checkpoint_dir`).  The architecture
    comes from the checkpoint (:data:`_ARCH_FIELDS`), the runtime flags
    from ``base_config``, as in the reference (model.py:215-220)."""
    if os.path.isfile(path):
        return import_torch_checkpoint(path, base_config)
    path = resolve_checkpoint_dir(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg_dict = json.load(f)
    for key in ("ncons_kernel_sizes", "ncons_channels"):
        cfg_dict[key] = tuple(cfg_dict[key])
    config = base_config.replace(
        **{k: cfg_dict[k] for k in _ARCH_FIELDS if k in cfg_dict})
    params = with_io_retries(lambda: load_tree(path, PARAMS_FILE),
                             what=f"restore of {path}")
    return config, params
