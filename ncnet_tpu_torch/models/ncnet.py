"""NCNet model assembly (the reference's ImMatchNet) in PyTorch.

Mirrors ``ncnet_tpu/models/ncnet.py``: backbone features → L2 norm → 4D
correlation → mutual matching → neighbourhood-consensus stack → mutual
matching.  Parameters are a plain tree ``{"backbone": {...}, "nc": [{"w",
"b"}, ...]}`` of tensors (trunk convs OIHW, NC weights ``(k, k, k, k, C_in,
C_out)``), and the forward is a function of ``(config, params, images)``
with the JAX package's channels-last layouts.

Under ``half_precision`` the volume and the NC weights are bf16 and the NC
stack runs through ``ops/nc_fused_lane.py`` (the CUDA kernels on the card,
their plain twins on the CPU): ``nc_stack_resident`` for inference, and
``nc_stack_fused`` (forward kernel, B3 backward kernels) when autograd
records, as the JAX package routes bf16 stacks to its Pallas kernels.  The
fp32 stack runs the plain ``ops/conv4d.py``, as the JAX package runs XLA
there.

The port runs the dense serving path and the training step
(``training/``).  ``check_ported`` rejects, with
``NotImplementedError``, every ``ModelConfig`` option it does not run yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.config import ModelConfig
from ncnet_tpu_torch.models import backbone as bb
from ncnet_tpu_torch.ops import nc_fused_lane
from ncnet_tpu_torch.ops.conv4d import conv4d, conv4d_init
from ncnet_tpu_torch.ops.correlation import correlation_4d
from ncnet_tpu_torch.ops.image import normalize_imagenet
from ncnet_tpu_torch.ops.matching import (
    Matches,
    corr_to_matches,
    mutual_matching,
)
from ncnet_tpu_torch.ops.norm import feature_l2_norm


def check_ported(config: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first option of ``config``
    that this slice of the port does not run."""
    unported = [
        ("relocalization_k_size", config.relocalization_k_size > 1),
        ("sparse_topk", config.sparse_topk > 0),
        ("track_radius", config.track_radius > 0),
        ("nc_tier", bool(config.nc_tier)),
        ("backbone", config.backbone not in ("resnet101", "tiny")),
        ("backbone_weights", bool(config.backbone_weights)),
        ("checkpoint", bool(config.checkpoint)),
    ]
    for name, hit in unported:
        if hit:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(config, name)!r} is not ported "
                "to ncnet_tpu_torch yet")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Without a usable CUDA device it raises instead of quietly
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: ncnet_tpu_torch entry points run on the "
            "GPU unless device='cpu' is passed")
    return dev


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists), with the
    matching leaves of ``rest``; None leaves stay None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The non-None leaves of ``tree`` in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def params_to(params, target) -> Any:
    """The parameter tree with every tensor moved by ``.to(target)`` (a
    device or a dtype)."""
    return tree_map(lambda t: t.to(target), params)


class NCNetOutput(NamedTuple):
    """Filtered correlation volume (+ relocalization offsets, not ported)."""

    corr: torch.Tensor                      # (B, hA, wA, hB, wB)
    delta4d: Optional[Tuple[torch.Tensor, ...]] = None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_ncnet(config: ModelConfig, seed: int = 1) -> Dict[str, Any]:
    """Random parameters (CPU tensors) for the full model from ``seed``:
    a He-initialized trunk and the NC stack with the reference Conv4d
    init.  The numbers differ from the JAX package's init at the same seed
    (different generators); tests share weights via ``models/convert.py``."""
    check_ported(config)
    if len(config.ncons_kernel_sizes) != len(config.ncons_channels):
        raise ValueError(
            "ncons_kernel_sizes and ncons_channels must have equal length, got "
            f"{config.ncons_kernel_sizes} vs {config.ncons_channels}")
    g = torch.Generator().manual_seed(seed)
    params: Dict[str, Any] = {
        "backbone": bb.backbone_init(config.backbone, g,
                                     last_layer=config.backbone_last_layer)}
    nc: List[Dict[str, torch.Tensor]] = []
    c_in = 1
    for k, c_out in zip(config.ncons_kernel_sizes, config.ncons_channels):
        w, b = conv4d_init(g, k, c_in, c_out)
        nc.append({"w": w, "b": b})
        c_in = c_out
    params["nc"] = nc
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _swap_ab(x: torch.Tensor) -> torch.Tensor:
    """A↔B transposition of a ``(B, hA, wA, hB, wB, C)`` volume."""
    return x.permute(0, 3, 4, 1, 2, 5)


def _check_training_args(remat_layers: bool, custom_grad) -> None:
    for name, hit in (("remat_nc_layers", remat_layers),
                      ("nc_custom_grad", custom_grad is not False)):
        if hit:
            raise NotImplementedError(
                f"{name} is not ported to ncnet_tpu_torch yet (a memory knob "
                "of the XLA backward; the port's bf16 backward is the B3 "
                "kernels)")


def neigh_consensus(nc_params: List[Dict[str, torch.Tensor]],
                    corr: torch.Tensor, *, symmetric: bool = True,
                    remat_layers: bool = False, custom_grad=False,
                    allow_pallas: bool = True, require_vjp: bool = False
                    ) -> torch.Tensor:
    """Neighbourhood-consensus filtering of the ``(B, hA, wA, hB, wB)``
    volume, with the reference's stack-level symmetry ``NC(x) + NC(xᵀ)ᵀ``
    (not a per-layer one: the ReLUs interleave).

    A square volume batch-folds ``[x, xᵀ]`` into one stack call
    (``ncnet_tpu/models/ncnet.py:615-624``); a rectangular one runs two
    passes (``:650-652``).  A bf16 volume with bf16 weights runs the stack
    through the CUDA kernels: ``nc_fused_lane.nc_stack_fused`` (forward
    and B3 backward) when autograd records, else
    ``nc_fused_lane.nc_stack_resident``.  An fp32 one runs the plain
    ``conv4d`` under autograd, as the JAX package runs XLA there.

    ``allow_pallas=False`` on a bf16 stack raises ``NotImplementedError``:
    the JAX package then runs XLA's formulation, and the port has no
    counterpart but the kernel.  ``require_vjp`` (the JAX training gate)
    needs no routing here: the kernel's backward always exists.
    ``remat_layers`` and ``custom_grad`` raise ``NotImplementedError``.
    """
    _check_training_args(remat_layers, custom_grad)
    x = corr[..., None]
    bf16 = x.dtype == torch.bfloat16
    if bf16 != all(layer["w"].dtype == torch.bfloat16 for layer in nc_params):
        raise TypeError(
            f"volume {x.dtype} and NC weights "
            f"{[layer['w'].dtype for layer in nc_params]} differ: cast both "
            "(ncnet_filter does under half_precision)")
    if bf16 and not allow_pallas:
        raise NotImplementedError(
            "a bf16 NC stack with nc_pallas=False (XLA's formulation in the "
            "JAX package) is not ported: the port's bf16 stack is the kernel")

    def stack(v: torch.Tensor) -> torch.Tensor:
        if bf16:
            if torch.is_grad_enabled() and (v.requires_grad or any(
                    t.requires_grad for layer in nc_params
                    for t in layer.values())):
                return nc_fused_lane.nc_stack_fused(nc_params, v)
            return nc_fused_lane.nc_stack_resident(nc_params, v)
        for layer in nc_params:
            v = torch.relu(conv4d(v, layer["w"], layer["b"]))
        return v

    if not symmetric:
        out = stack(x)
    elif x.shape[1:3] == x.shape[3:5]:
        b = x.shape[0]
        y = stack(torch.cat([x, _swap_ab(x)], dim=0))
        out = y[:b] + _swap_ab(y[b:])
    else:
        out = stack(x) + _swap_ab(stack(_swap_ab(x).contiguous()))
    return out[..., 0]


def extract_features(config: ModelConfig, params, images: torch.Tensor
                     ) -> torch.Tensor:
    """Backbone features ``(B, h, w, C)``, L2-normalized per location when
    ``config.normalize_features``.  ``backbone_bf16`` runs the trunk in
    bf16; the norm is taken in float32 either way."""
    check_ported(config)
    bb_params = params["backbone"]
    if config.backbone_bf16:
        bb_params = params_to(bb_params, torch.bfloat16)
        images = images.to(torch.bfloat16)
    feats = bb.backbone_apply(config.backbone, bb_params, images,
                              last_layer=config.backbone_last_layer)
    if config.backbone_bf16:
        feats = feats.to(torch.float32)
    if config.normalize_features:
        feats = feature_l2_norm(feats)
    return feats


def ncnet_filter(config: ModelConfig, params, corr: torch.Tensor,
                 remat_nc_layers: bool = False, nc_custom_grad: bool = False,
                 nc_pallas: bool = True, nc_pallas_vjp: bool = False
                 ) -> NCNetOutput:
    """MutualMatching → NeighConsensus → MutualMatching, in bf16 when
    ``half_precision`` (volume and NC weights cast together, differentiably:
    the gradients of f32 weights come back in f32).  The training arguments
    are :func:`neigh_consensus`'s (``nc_pallas`` is its ``allow_pallas``,
    ``nc_pallas_vjp`` its ``require_vjp``)."""
    check_ported(config)
    nc_params = params["nc"]
    if config.half_precision:
        nc_params = [{k: v.to(torch.bfloat16) for k, v in layer.items()}
                     for layer in nc_params]
        corr = corr.to(torch.bfloat16)
    corr = mutual_matching(corr)
    corr = neigh_consensus(nc_params, corr, symmetric=config.symmetric_mode,
                           remat_layers=remat_nc_layers,
                           custom_grad=nc_custom_grad, allow_pallas=nc_pallas,
                           require_vjp=nc_pallas_vjp)
    corr = mutual_matching(corr)
    return NCNetOutput(corr, None)


def ncnet_match_volume(config: ModelConfig, params, fa: torch.Tensor,
                       fb: torch.Tensor) -> NCNetOutput:
    """Correlation + filtering of a feature pair: the dense branch (the
    coarse-to-fine branch is not ported)."""
    check_ported(config)
    return ncnet_filter(config, params, correlation_4d(fa, fb))


def ncnet_forward_from_feature_pair(config: ModelConfig, params,
                                    source_features: torch.Tensor,
                                    target_features: torch.Tensor
                                    ) -> NCNetOutput:
    """Forward with both sides' features precomputed (float32
    ``extract_features`` outputs; the bf16 cast happens here)."""
    fa, fb = source_features, target_features
    if config.half_precision:
        fa, fb = fa.to(torch.bfloat16), fb.to(torch.bfloat16)
    return ncnet_match_volume(config, params, fa, fb)


def ncnet_forward_from_features(config: ModelConfig, params,
                                source_features: torch.Tensor,
                                target_images: torch.Tensor) -> NCNetOutput:
    """Forward with the source side's features precomputed."""
    fb = extract_features(config, params, target_images)
    return ncnet_forward_from_feature_pair(config, params, source_features, fb)


def ncnet_forward(config: ModelConfig, params, source_images: torch.Tensor,
                  target_images: torch.Tensor) -> NCNetOutput:
    """Full forward on normalized ``(B, H, W, 3)`` image batches; returns
    the filtered volume ``(B, hA, wA, hB, wB)``."""
    fa = extract_features(config, params, source_images)
    return ncnet_forward_from_features(config, params, fa, target_images)


def make_point_matcher(config: ModelConfig, params, *, do_softmax: bool = True,
                       scale: str = "centered", device=None):
    """Warm single-pair matcher: weights staged on ``device`` (CUDA by
    default) once; ``matcher(src_u8, tgt_u8)`` takes raw uint8 ``(1, H, W,
    3)`` images, normalizes them on the device and returns the
    ``corr_to_matches`` table as :class:`Matches` of ``(1, N)`` numpy
    arrays.  ``dispatch``/``fetch`` split the call; the quality signals ride
    in a sixth table row (``fetch_with_quality``)."""
    from ncnet_tpu_torch.observability.quality import (
        append_quality_row,
        split_quality_row,
    )

    check_ported(config)
    dev = resolve_device(device)
    staged = params_to(params, dev)

    @torch.no_grad()
    def dispatch(src, tgt) -> torch.Tensor:
        src = normalize_imagenet(torch.as_tensor(np.asarray(src)).to(dev))
        tgt = normalize_imagenet(torch.as_tensor(np.asarray(tgt)).to(dev))
        out = ncnet_forward(config, staged, src, tgt)
        m = corr_to_matches(out.corr, do_softmax=do_softmax, scale=scale)
        table = torch.stack([v.to(torch.float32).reshape(-1) for v in m])
        return append_quality_row(table, out.corr)

    def fetch_with_quality(handle):
        table, quality = split_quality_row(
            handle.to("cpu", torch.float32).numpy())
        matcher.last_quality = quality
        return Matches(*(table[i][None] for i in range(5))), quality

    def fetch(handle) -> Matches:
        return fetch_with_quality(handle)[0]

    def match_with_quality(src, tgt):
        return fetch_with_quality(dispatch(src, tgt))

    def matcher(src, tgt) -> Matches:
        return fetch(dispatch(src, tgt))

    matcher.dispatch = dispatch
    matcher.fetch = fetch
    matcher.fetch_with_quality = fetch_with_quality
    matcher.match_with_quality = match_with_quality
    matcher.last_quality = None
    return matcher


class NCNet:
    """Config + params bundled with a callable forward, on ``device`` (CUDA
    by default).  ``NCNet(cfg, params)`` stages the given params;
    ``NCNet(cfg, seed=s)`` initializes them randomly."""

    def __init__(self, config: ModelConfig = ModelConfig(), params=None,
                 seed: int = 1, device=None):
        check_ported(config)
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            params = init_ncnet(config, seed)
        self.params = params_to(params, self.device)

    @torch.no_grad()
    def __call__(self, source_images, target_images) -> NCNetOutput:
        return ncnet_forward(self.config, self.params,
                             source_images.to(self.device),
                             target_images.to(self.device))
