"""NCNet model assembly (the reference's ImMatchNet) in PyTorch.

Mirrors ``ncnet_tpu/models/ncnet.py``: backbone features → L2 norm → 4D
correlation → mutual matching → neighbourhood-consensus stack → mutual
matching.  Parameters are a plain tree ``{"backbone": {...}, "nc": [{"w",
"b"}, ...]}`` of tensors (trunk convs OIHW, NC weights ``(k, k, k, k, C_in,
C_out)``), and the forward is a function of ``(config, params, images)``
with the JAX package's channels-last layouts.

The NC stack goes where the JAX package sends it (:func:`neigh_consensus`):
the tier chooser ``ops/nc_fused_lane.py::choose_fused_stack`` ranks the
arithmetic tiers (CP, FFT; any dtype) above the bf16 kernel B2, and a stack
no tier takes runs layer by layer through ``ops/conv4d.py``'s formulations,
whose chooser sends a small-C_out layer to the B5 kernel
(``ops/conv4d_pallas.py``).  The CUDA kernels run on the card, their plain
twins on the CPU.

The port runs the dense serving path, with relocalization
(``relocalization_k_size`` > 1: the volume max-pooled by k before the
filter, ``ops/pooling.py``), the training step (``training/``)
and the coarse-to-fine and tracked match pipelines
(``ModelConfig.sparse_topk`` > 0: :func:`coarse2fine_filter`,
:func:`ncnet_forward_tracked`; the gathered tiles go through
``ops/sparse_corr.py`` and its B4 kernel, then through the same NC stack).
A rectangular volume (InLoc's portrait query against a landscape cutout)
filters its symmetric pass as the tap-swapped stack on the volume itself
(:func:`tap_swap_chain`), not as a second pass on its transpose.
``check_ported`` rejects, with ``NotImplementedError``, every
``ModelConfig`` option it does not run yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ncnet_tpu_torch.config import ModelConfig
from ncnet_tpu_torch.models import backbone as bb
from ncnet_tpu_torch.ops import nc_fused_lane
from ncnet_tpu_torch.ops.conv4d import (
    choose_conv4d_variant,
    conv4d,
    conv4d_init,
    conv4d_same,
)
from ncnet_tpu_torch.ops.conv4d_cp import cp_stack_ranks, nc_stack_cp
from ncnet_tpu_torch.ops.conv4d_fft import nc_stack_fft
from ncnet_tpu_torch.ops.correlation import correlation_4d
from ncnet_tpu_torch.ops.image import normalize_imagenet
from ncnet_tpu_torch.ops.matching import (
    Matches,
    corr_to_matches,
    mutual_matching,
)
from ncnet_tpu_torch.ops.norm import feature_l2_norm
from ncnet_tpu_torch.ops.pooling import maxpool4d_with_argmax
from ncnet_tpu_torch.utils.seeding import torch_generator


def check_ported(config: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first option of ``config``
    that the port does not run.  Every trunk runs; the torchvision and
    reference importers (``backbone_weights``, a ``.pth.tar``
    ``checkpoint``) read ResNet-101, VGG-16 and DenseNet-201, and no file
    of either kind exists for the ``tiny`` test trunk (decided from the
    names alone); a native checkpoint directory (``models/checkpoint.py``)
    loads for every trunk."""
    tiny = config.backbone == "tiny"
    unported = [
        ("backbone_weights", bool(config.backbone_weights) and tiny),
        ("checkpoint", bool(config.checkpoint) and tiny
         and config.checkpoint.endswith(".pth.tar")),
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
    """Filtered correlation volume, and the relocalization offsets
    ``(di, dj, dk, dl)`` (int32, shaped like ``corr``) when the volume was
    max-pooled (``relocalization_k_size`` > 1)."""

    corr: torch.Tensor                      # (B, hA, wA, hB, wB)
    delta4d: Optional[Tuple[torch.Tensor, ...]] = None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_ncnet(config: ModelConfig, seed: int = 1) -> Dict[str, Any]:
    """Parameters (CPU tensors) for the full model from ``seed``: the NC
    stack with the reference Conv4d init, and the trunk from
    ``config.backbone_weights`` (a torchvision ``state_dict``) when given,
    else He-initialized.  The numbers differ from the JAX package's init
    at the same seed (different generators); tests share weights via
    ``models/convert.py``."""
    check_ported(config)
    if len(config.ncons_kernel_sizes) != len(config.ncons_channels):
        raise ValueError(
            "ncons_kernel_sizes and ncons_channels must have equal length, got "
            f"{config.ncons_kernel_sizes} vs {config.ncons_channels}")
    g = torch_generator(seed)
    # drawn even when the weights file replaces it, so that the NC init at a
    # seed does not depend on backbone_weights
    trunk = bb.backbone_init(config.backbone, g,
                             last_layer=config.backbone_last_layer)
    if config.backbone_weights:
        from ncnet_tpu_torch.models.checkpoint import load_backbone_weights

        trunk = load_backbone_weights(config.backbone_weights, config)
    elif config.backbone in ("resnet101", "vgg", "densenet201"):
        import warnings

        warnings.warn(
            f"initializing a '{config.backbone}' trunk with RANDOM weights "
            "— the reference always uses ImageNet-pretrained weights; pass "
            "backbone_weights=<torchvision .pth> (or a checkpoint) for "
            "meaningful features", stacklevel=2)
    params: Dict[str, Any] = {"backbone": trunk}
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


def swap_ab_taps(layer: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The layer whose plain application equals ``transpose ∘ layer ∘
    transpose`` (A↔B volume transposition): kernel tap groups (kA, kWA)
    and (kB, kWB) swapped, channels untouched.  Requires a cubic kernel."""
    return {"w": layer["w"].permute(2, 3, 0, 1, 4, 5).contiguous(),
            "b": layer["b"]}


def tap_swap_fusable(nc_params) -> bool:
    """Whether the symmetric pass may run as tap-swapped stacks with a
    fused first layer: cubic kernels, exactly two layers, a 1-channel
    input (the shape class of ``ncnet_tpu/models/ncnet.py:322``)."""
    return (len(nc_params) == 2
            and nc_params[0]["w"].shape[4] == 1
            and all(tuple(layer["w"].shape[0:2]) == tuple(layer["w"].shape[2:4])
                    for layer in nc_params))


def tap_swap_fused_layers(nc_params):
    """``(fused_l1, l2, l2_swapped)`` of the tap-swapped symmetric pass:
    the first layer and its tap-swapped twin side by side (1 → 2C), the
    second layer, and its tap-swapped twin.  :func:`tap_swap_chain` builds
    from it."""
    sw = [swap_ab_taps(layer) for layer in nc_params]
    fused_l1 = {"w": torch.cat([nc_params[0]["w"], sw[0]["w"]], dim=-1),
                "b": torch.cat([nc_params[0]["b"], sw[0]["b"]])}
    return fused_l1, nc_params[1], sw[1]


def tap_swap_chain(nc_params):
    """The tap-swapped symmetric pass as one 2-layer chain for the kernel
    tier: ``[fused L1 (1 → 2C), block-diagonal L2 (2C → 2)]``.  The final
    layer applies L2 to channels ``:C`` (output channel 0) and L2ᵀ to
    channels ``C:`` (output channel 1), each with its own bias, so the
    kernel's bias and ReLU apply to each stack apart and the sum of the two
    output channels is ``relu(L2(y_a)) + relu(L2ᵀ(y_b))``."""
    fused_l1, l2, l2s = tap_swap_fused_layers(nc_params)
    zero = torch.zeros_like(l2["w"])
    w_bd = torch.cat([torch.cat([l2["w"], zero], dim=4),
                      torch.cat([zero, l2s["w"]], dim=4)], dim=5)
    return [fused_l1, {"w": w_bd, "b": torch.cat([l2["b"], l2s["b"]])}]


def neigh_consensus(nc_params: List[Dict[str, torch.Tensor]],
                    corr: torch.Tensor, *, symmetric: bool = True,
                    remat_layers: bool = False, custom_grad: bool = False,
                    allow_pallas: bool = True, require_vjp: bool = False,
                    force_tier: Optional[str] = None) -> torch.Tensor:
    """Neighbourhood-consensus filtering of the ``(B, hA, wA, hB, wB)``
    volume, with the reference's stack-level symmetry ``NC(x) + NC(xᵀ)ᵀ``
    (not a per-layer one: the ReLUs interleave).  The routing of
    ``ncnet_tpu/models/ncnet.py:442-652``:

    * ``force_tier`` (``'cp'`` or ``'fft'``, ``ModelConfig.nc_tier``) runs
      that arithmetic tier unconditionally; ``'cp'`` needs factors on every
      layer.
    * ``require_vjp`` (the training gate, with ``allow_pallas``): a bf16
      stack the kernels hold (``nc_fused_lane.kernels_hold``: B2's shape
      class within the kernels' limits, forward and B3 backward alike)
      runs ``nc_fused_lane.nc_stack_fused``, whose forward asks the tier
      chooser (the FFT tier at the PF-Pascal 25⁴ volume) and whose
      backward is B3.  On a rectangular volume a tap-swap-fusable stack
      takes its chain (:func:`tap_swap_chain`) the same way when the
      chooser gives the chain the kernel tier and the gate holds it
      (``ncnet_tpu/models/ncnet.py:513-523``).
    * Otherwise, with ``allow_pallas`` and neither ``remat_layers`` nor
      ``custom_grad``, ``nc_fused_lane.choose_fused_stack`` decides for
      every orientation the call runs: an arithmetic tier that wins them
      all runs the whole stack; a bf16 stack whose decisions are all
      kernel tiers runs B2 (``nc_stack_fused`` when autograd records, which
      needs the backward's shapes too).
      The chooser takes the kernel tier only for stacks the kernels hold,
      so any other stack falls to the line below before any launch.
    * Everything else runs layer by layer through ``conv4d``'s formulation
      chooser (``"pallas"``, B5, for a small-C_out layer): through
      :func:`~ncnet_tpu_torch.ops.conv4d.conv4d_same` when ``custom_grad``,
      one ``torch.utils.checkpoint`` per layer under ``remat_layers``.

    A square volume batch-folds ``[x, xᵀ]`` into one stack call when a
    tier runs the stack or every layer keeps a channel-folding formulation
    at the doubled batch (``:607-624``).  Otherwise a stack in the
    tap-swap class (:func:`tap_swap_fusable`: two cubic layers on a
    1-channel input) with no arithmetic tier runs the transposed pass
    algebraically (``:625-649``): ``NC(xᵀ)ᵀ`` is the tap-swapped stack on
    ``x``, and the two first layers fuse into one 1 → 2C layer.  Where the
    chooser gives the kernel tier for :func:`tap_swap_chain` (bf16, a
    rectangular volume), that chain is one stack call whose two output
    channels are summed; where no tier runs the stack (fp32, or a stack
    outside the kernels' gate), the fused first layer runs once and the
    second layer and its tap-swapped twin run on its two channel halves,
    through the formulations.  Deeper stacks, and a stack on the kernel
    tier whose chain the chooser does not give the kernel tier, run the
    two passes one after the other.
    """
    conv = conv4d_same if custom_grad else conv4d

    def one_layer(w, b, v):
        if remat_layers:
            return checkpoint(lambda w, b, v: torch.relu(conv(v, w, b)),
                              w, b, v, use_reentrant=False)
        return torch.relu(conv(v, w, b))

    x = corr[..., None]
    bf16 = x.dtype == torch.bfloat16
    if bf16 != all(layer["w"].dtype == torch.bfloat16 for layer in nc_params):
        raise TypeError(
            f"volume {x.dtype} and NC weights "
            f"{[layer['w'].dtype for layer in nc_params]} differ: cast both "
            "(ncnet_filter does under half_precision)")
    # whether autograd records this call: the kernel tier then runs the
    # backward kernels too
    records_grad = torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for layer in nc_params for t in (layer["w"], layer["b"])))
    tier_eligible = allow_pallas and not remat_layers and not custom_grad
    use_fused = False
    fused_tap_swap = False
    arith_tier = None
    b, ha, wa, hb, wb = corr.shape
    kernels = tuple(int(layer["w"].shape[0]) for layer in nc_params)
    channels = tuple(int(layer["w"].shape[5]) for layer in nc_params)
    tap_swap = tap_swap_fusable(nc_params)
    rect = symmetric and (ha, wa) != (hb, wb)
    # the tap-swap chain's channels: the fused first layer and the
    # block-diagonal final one
    chain = (2 * channels[0], 2) if tap_swap else None
    shapes = [(ha, wa, hb, wb)]
    if rect:
        # the rectangular two-pass form also runs the transposed volume
        shapes.append((hb, wb, ha, wa))
    if force_tier:
        if force_tier not in ("cp", "fft"):
            raise ValueError(
                f"force_tier must be 'cp' or 'fft', got {force_tier!r}")
        if force_tier == "cp" and cp_stack_ranks(nc_params) is None:
            raise ValueError(
                "force_tier='cp' needs CP factors on every NC layer "
                "(ops/cp_als.py::decompose_stack attaches them)")
        arith_tier = force_tier
        nc_fused_lane.note_forced_tier(force_tier)
    elif tier_eligible and require_vjp:
        # the training gate fuses only where the kernels hold the stack,
        # forward and B3 backward alike (the arithmetic tiers are never
        # auto-selected here; the fused stack's own forward may still take
        # one); any other stack runs the formulations per layer with
        # autograd through them, reported as "xla".  A rectangular
        # tap-swap-fusable stack takes its chain where the chooser gives
        # the chain the kernel tier (the JAX gate: choose_fused_stack ==
        # "resident" and choose_fused_vjp), else the two passes.
        use_fused = bf16 and nc_fused_lane.kernels_hold(kernels, channels)
        if use_fused and rect and tap_swap:
            fused_tap_swap = nc_fused_lane.choose_fused_stack(
                ha, wa, hb, wb, kernels, chain) == "resident"
        if not use_fused:
            nc_fused_lane.note_forced_tier("xla")
    elif tier_eligible:
        cp_ranks = cp_stack_ranks(nc_params)
        decisions = [nc_fused_lane.choose_fused_stack(
            *s, kernels, channels, cp_ranks=cp_ranks, pallas_ok=bf16)
            for s in shapes]
        if decisions[0] in ("cp", "fft") \
                and all(d == decisions[0] for d in decisions):
            arith_tier = decisions[0]
        else:
            # an arithmetic tier's decision still needs B3 when autograd
            # records
            use_fused = bf16 and all(d is not None for d in decisions) and (
                not records_grad
                or nc_fused_lane.kernels_hold(kernels, channels))
        if bf16 and arith_tier is None and rect and tap_swap:
            fused_tap_swap = nc_fused_lane.choose_fused_stack(
                ha, wa, hb, wb, kernels, chain) == "resident"
            if not fused_tap_swap:
                # the chain's decision is not the route: record the one
                # that runs (two passes on the kernel, or the formulations)
                nc_fused_lane.note_forced_tier(
                    "resident" if use_fused else "xla")

    def fused(params, v: torch.Tensor) -> torch.Tensor:
        if records_grad:
            return nc_fused_lane.nc_stack_fused(params, v)
        return nc_fused_lane.fused_stack_forward(params, v)

    def stack(v: torch.Tensor) -> torch.Tensor:
        if arith_tier == "cp":
            return nc_stack_cp(nc_params, v)
        if arith_tier == "fft":
            return nc_stack_fft(nc_params, v)
        if use_fused:
            return fused(nc_params, v)
        for layer in nc_params:
            v = one_layer(layer["w"], layer["b"], v)
        return v

    if not symmetric:
        return stack(x)[..., 0]
    # folding the two passes into the batch doubles every intermediate; ask
    # the formulation chooser whether every layer keeps a channel fold at
    # the doubled batch (the tiers never build a folded copy)
    fold_ok = use_fused or arith_tier is not None or all(
        choose_conv4d_variant(
            int(layer["w"].shape[4]), int(layer["w"].shape[5]), hb, wb,
            shape_a=(ha, wa), kernel=tuple(layer["w"].shape[:4]),
            dtype=x.dtype, batch=2 * b) != "unroll"
        for layer in nc_params)
    if (ha, wa) == (hb, wb) and fold_ok:
        y = stack(torch.cat([x, _swap_ab(x)], dim=0))
        out = y[:b] + _swap_ab(y[b:])
    elif tap_swap and arith_tier is None and (fused_tap_swap or not use_fused):
        # the transposed pass as the tap-swapped stack on x: transposition
        # commutes with ReLU and swaps a cubic kernel's A and B tap groups,
        # and the two stacks' 1-channel first layers fuse into one conv.  A
        # stack the kernel tier runs whose chain it does not keeps the two
        # passes on the kernel.
        if fused_tap_swap:
            y2 = fused(tap_swap_chain(nc_params), x)
            out = y2[..., :1] + y2[..., 1:]
        else:
            fused_l1, l2, l2s = tap_swap_fused_layers(nc_params)
            y = one_layer(fused_l1["w"], fused_l1["b"], x)  # 1 → 2C, once
            c = channels[0]
            out = (one_layer(l2["w"], l2["b"], y[..., :c])
                   + one_layer(l2s["w"], l2s["b"], y[..., c:]))
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


def calibrate_trunk(config: ModelConfig, params, images: torch.Tensor
                    ) -> None:
    """Set every BatchNorm of the trunk in ``params`` to the statistics of
    its input on ``images``, layer after layer in one pass (a data-dependent
    init; a trained trunk's running statistics are its data's).  With the
    raw init (mean 0, variance 1) a random ResNet-101's layer3 features are
    near-parallel from cell to cell, so every pair looks alike: every bf16
    pair score rounds to the same value, and a scene cut leaves the match
    quality unchanged.  Pass a config without ``backbone_bf16`` (that runs
    the trunk on a cast copy)."""
    real = bb._bn

    def bn(x, p):
        p["mean"] = x.mean(dim=(0, 2, 3))
        p["var"] = x.var(dim=(0, 2, 3), unbiased=False)
        return real(x, p)

    bb._bn = bn
    try:
        with torch.no_grad():
            extract_features(config, params, images)
    finally:
        bb._bn = real


def ncnet_filter(config: ModelConfig, params, corr: torch.Tensor,
                 remat_nc_layers: bool = False, nc_custom_grad: bool = False,
                 nc_pallas: bool = True, nc_pallas_vjp: bool = False
                 ) -> NCNetOutput:
    """[maxpool4d] → MutualMatching → NeighConsensus → MutualMatching, in
    bf16 when ``half_precision`` (volume and NC weights cast together,
    differentiably: the gradients of f32 weights come back in f32; the cast
    comes before the pooling, as in the JAX package).  With
    ``relocalization_k_size`` > 1 the volume is max-pooled by k first and
    the output carries the offsets.  The training arguments are
    :func:`neigh_consensus`'s (``nc_pallas`` is its ``allow_pallas``,
    ``nc_pallas_vjp`` its ``require_vjp``)."""
    check_ported(config)
    nc_params = params["nc"]
    if config.half_precision:
        nc_params = params_to(nc_params, torch.bfloat16)
        corr = corr.to(torch.bfloat16)
    delta4d = None
    if config.relocalization_k_size > 1:
        corr, delta4d = maxpool4d_with_argmax(corr,
                                              config.relocalization_k_size)
    corr = mutual_matching(corr)
    corr = neigh_consensus(nc_params, corr, symmetric=config.symmetric_mode,
                           remat_layers=remat_nc_layers,
                           custom_grad=nc_custom_grad, allow_pallas=nc_pallas,
                           require_vjp=nc_pallas_vjp,
                           force_tier=config.nc_tier or None)
    corr = mutual_matching(corr)
    return NCNetOutput(corr, delta4d)


def ncnet_match_volume(config: ModelConfig, params, fa: torch.Tensor,
                       fb: torch.Tensor) -> NCNetOutput:
    """Correlation + filtering of a feature pair: the coarse-to-fine
    pipeline (:func:`coarse2fine_filter`) where ``config.sparse_topk`` > 0
    and ``sparse_corr.choose_match_pipeline`` admits the shape, else the
    dense correlation and :func:`ncnet_filter`.  Every feature-pair
    forward goes through here."""
    from ncnet_tpu_torch.ops.sparse_corr import choose_match_pipeline
    from ncnet_tpu_torch.ops.sparse_topk import resolve_halo

    check_ported(config)
    tier = choose_match_pipeline(
        fa.shape[1], fa.shape[2], fb.shape[1], fb.shape[2],
        sparse_topk=config.sparse_topk, factor=config.sparse_factor,
        halo=resolve_halo(config.sparse_halo, config.sparse_factor),
        reloc_k=config.relocalization_k_size)
    if tier == "coarse2fine":
        return coarse2fine_filter(config, params, fa, fb)
    return ncnet_filter(config, params, correlation_4d(fa, fb))


def _cast_for_sparse(config: ModelConfig, params, fa: torch.Tensor,
                     fb: torch.Tensor):
    nc_params = params["nc"]
    if config.half_precision:
        nc_params = params_to(nc_params, torch.bfloat16)
        fa, fb = fa.to(torch.bfloat16), fb.to(torch.bfloat16)
    return nc_params, fa, fb


def coarse2fine_filter(config: ModelConfig, params, fa: torch.Tensor,
                       fb: torch.Tensor) -> NCNetOutput:
    """The coarse-to-fine match pipeline
    (``ncnet_tpu/models/ncnet.py::coarse2fine_filter``):

      1. coarse pass: both feature grids pooled by ``config.sparse_factor``
         and the coarse volume through the unchanged :func:`ncnet_filter`
         (same weights);
      2. symmetric candidate selection: top-k per coarse source cell over
         the targets and per coarse target cell over the sources
         (``sparse_topk.topk_candidates``);
      3. the sparse fine pass of both families (:func:`_sparse_dual_refine`).

    Returns the dense-shaped volume, zeros off the candidate support.
    Callers gate eligibility through ``choose_match_pipeline``
    (:func:`ncnet_match_volume` does)."""
    from ncnet_tpu_torch.ops.sparse_topk import (
        pool_features,
        resolve_halo,
        topk_candidates,
    )

    nc_params, fa, fb = _cast_for_sparse(config, params, fa, fb)
    factor = config.sparse_factor
    halo = resolve_halo(config.sparse_halo, factor)
    fac = pool_features(fa, factor, renormalize=config.normalize_features)
    fbc = pool_features(fb, factor, renormalize=config.normalize_features)
    coarse = ncnet_filter(config, params, correlation_4d(fac, fbc))
    cand_ab = topk_candidates(coarse.corr, config.sparse_topk)
    cand_ba = topk_candidates(coarse.corr.permute(0, 3, 4, 1, 2),
                              config.sparse_topk)
    return _sparse_dual_refine(config, nc_params, fa, fb, cand_ab, cand_ba,
                               factor=factor, halo=halo)


def _sparse_dual_refine(config: ModelConfig, nc_params, fa: torch.Tensor,
                        fb: torch.Tensor, cand_ab: torch.Tensor,
                        cand_ba: torch.Tensor, *, factor: int,
                        halo: int) -> NCNetOutput:
    """The fine pass shared by :func:`coarse2fine_filter` and
    :func:`coarse2fine_tracked_filter`: both candidate families through the
    gathered-tile NC stack, merged on the dense frame by max.  Inputs are
    already cast by the caller."""
    from ncnet_tpu_torch.ops.sparse_corr import sparse_refine

    def stack_fn(vol: torch.Tensor) -> torch.Tensor:
        # the folded tiles consult the same tier chooser as the dense
        # volume; config.nc_tier forces the arithmetic tier here too
        return neigh_consensus(nc_params, vol, symmetric=config.symmetric_mode,
                               force_tier=config.nc_tier or None)

    def stack_fn_t(vol: torch.Tensor) -> torch.Tensor:
        # the role-swapped family: the symmetric stack commutes with the
        # A↔B transposition; an asymmetric one is conjugated by it
        if config.symmetric_mode:
            return stack_fn(vol)
        vt = vol.permute(0, 3, 4, 1, 2).contiguous()
        return stack_fn(vt).permute(0, 3, 4, 1, 2)

    vol_ab = sparse_refine(fa, fb, cand_ab, factor=factor, halo=halo,
                           stack_fn=stack_fn)
    vol_ba = sparse_refine(fb, fa, cand_ba, factor=factor, halo=halo,
                           stack_fn=stack_fn_t)
    return NCNetOutput(torch.maximum(vol_ab, vol_ba.permute(0, 3, 4, 1, 2)),
                       None)


def coarse2fine_tracked_filter(config: ModelConfig, params, fa: torch.Tensor,
                               fb: torch.Tensor, prior_ab, prior_ba
                               ) -> NCNetOutput:
    """The tracked pipeline: the coarse-to-fine fine pass with the coarse
    pass replaced by the previous frame's priors (``(B, Nc)`` int32, from
    ``ops/temporal.prior_from_table``), each dilated by the static
    ``(2·track_radius+1)²`` window.  At full window coverage it is bitwise
    :func:`coarse2fine_filter` at full k (the same
    :func:`_sparse_dual_refine`)."""
    from ncnet_tpu_torch.ops.sparse_topk import resolve_halo
    from ncnet_tpu_torch.ops.temporal import temporal_candidates

    nc_params, fa, fb = _cast_for_sparse(config, params, fa, fb)
    factor = config.sparse_factor
    halo = resolve_halo(config.sparse_halo, factor)
    hac, wac = fa.shape[1] // factor, fa.shape[2] // factor
    hbc, wbc = fb.shape[1] // factor, fb.shape[2] // factor
    prior_ab = torch.as_tensor(prior_ab).to(fa.device)
    prior_ba = torch.as_tensor(prior_ba).to(fa.device)
    cand_ab = temporal_candidates(prior_ab, hbc, wbc, config.track_radius)
    cand_ba = temporal_candidates(prior_ba, hac, wac, config.track_radius)
    return _sparse_dual_refine(config, nc_params, fa, fb, cand_ab, cand_ba,
                               factor=factor, halo=halo)


def ncnet_forward_tracked(config: ModelConfig, params,
                          source_features: torch.Tensor,
                          target_images: torch.Tensor, prior_ab,
                          prior_ba) -> NCNetOutput:
    """Streaming forward: the source features precomputed (float32
    ``extract_features`` outputs), the target frame extracted here, and the
    volume built by the tracked pipeline where
    ``sparse_corr.choose_tracked_pipeline`` admits the shape, else by
    :func:`ncnet_match_volume`."""
    from ncnet_tpu_torch.ops.sparse_corr import choose_tracked_pipeline
    from ncnet_tpu_torch.ops.sparse_topk import resolve_halo

    fa = source_features
    fb = extract_features(config, params, target_images)
    if config.half_precision:
        fa, fb = fa.to(torch.bfloat16), fb.to(torch.bfloat16)
    tier = choose_tracked_pipeline(
        fa.shape[1], fa.shape[2], fb.shape[1], fb.shape[2],
        factor=config.sparse_factor,
        halo=resolve_halo(config.sparse_halo, config.sparse_factor),
        radius=config.track_radius, reloc_k=config.relocalization_k_size)
    if tier == "tracked":
        return coarse2fine_tracked_filter(config, params, fa, fb, prior_ab,
                                          prior_ba)
    return ncnet_match_volume(config, params, fa, fb)


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
        # a relocalized volume carries its offsets: the matches land on the
        # fine grid
        m = corr_to_matches(out.corr, delta4d=out.delta4d,
                            k_size=max(config.relocalization_k_size, 1),
                            do_softmax=do_softmax, scale=scale)
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
    by default).  ``NCNet(cfg, params)`` stages the given params; without
    them ``cfg.checkpoint`` (a reference ``.pth.tar``, a native directory
    or a ``fit`` root, whose stored architecture then overrides ``cfg``'s,
    ``models/checkpoint.py``) is loaded, else ``NCNet(cfg, seed=s)``
    initializes them
    (:func:`init_ncnet`)."""

    def __init__(self, config: ModelConfig = ModelConfig(), params=None,
                 seed: int = 1, device=None):
        check_ported(config)
        self.device = resolve_device(device)
        if params is None and config.checkpoint:
            from ncnet_tpu_torch.models.checkpoint import load_params

            config, params = load_params(config.checkpoint, config)
            check_ported(config)
        self.config = config
        if params is None:
            params = init_ncnet(config, seed)
        self.params = params_to(params, self.device)

    @torch.no_grad()
    def __call__(self, source_images, target_images) -> NCNetOutput:
        return ncnet_forward(self.config, self.params,
                             source_images.to(self.device),
                             target_images.to(self.device))
