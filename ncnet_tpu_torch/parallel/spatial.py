"""The hB-sharded 4D-volume forward, the port of ``ncnet_tpu/parallel/
spatial.py``.

The correlation volume ``(B, hA, wA, hB, wB)`` is quadratic in the
resolution; at InLoc's settings it is the memory wall.  Here it is split
along hB over the mesh's ``spatial`` axis (``parallel/mesh.py``), one
shard a device of this process, and every stage after the correlation runs
shard by shard with the exchanges written out (ROADMAP D7):

  * correlation     — each shard contracts the whole source feature map
                      (copied to every shard's device) against its own hB
                      feature rows: no exchange;
  * maxpool4d       — shard-local (shard boundaries are multiples of k);
  * MutualMatching  — the max over the A dims is local; the max over the B
                      dims gathers each shard's small max tensor onto the
                      first shard's device, reduces, and copies the result
                      back (reference semantics: lib/model.py:155-175);
  * conv4d          — each layer first takes ``k // 2`` hB slabs from each
                      neighbour (``Tensor.to(device, non_blocking=True)``;
                      the outer edges take zeros, which is the unsharded
                      'same' zero padding), then convolves *valid* along hB
                      (``ops/conv4d.py``'s ``pad_hb=False`` forms).  The
                      symmetric pass runs tap-swapped on the same shards
                      where the stack is in that shape class, else on the
                      A↔B transpose, whose sharded dim is then the leading
                      one (``pad_ha=False``).

A volume whose hB does not divide over ``n_shards·k`` is zero-padded along
hB up to the next multiple (pad-and-mask): the pad rows are −inf'd out of
the B-side max and re-zeroed after every conv layer, so the real rows
compute the unsharded function, and the output is sliced back.  The
sharded NC stack runs the ``conv4d`` formulations, as JAX's does
(``spatial.py:146-177``): never the B6 stack kernel, and never the
same-padded B5 kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ncnet_tpu_torch.config import ModelConfig
from ncnet_tpu_torch.models.ncnet import (
    NCNetOutput,
    extract_features,
    params_to,
    tap_swap_fusable,
    tap_swap_fused_layers,
)
from ncnet_tpu_torch.ops.conv4d import conv4d
from ncnet_tpu_torch.ops.correlation import correlation_4d
from ncnet_tpu_torch.ops.pooling import maxpool4d_with_argmax
from ncnet_tpu_torch.parallel.mesh import SPATIAL_AXIS, Mesh


def padded_hb(hb_fine: int, k_size: int, n_shards: int) -> Optional[int]:
    """Fine-grid hB after pad-to-shardable: the smallest multiple of
    ``n_shards·k`` ≥ ``hb_fine``; None when ``hb_fine`` is not itself a
    multiple of ``k`` (the unsharded pooling's ragged last window would mix
    real and pad rows)."""
    k = max(k_size, 1)
    if hb_fine % k != 0:
        return None
    step = n_shards * k
    return ((hb_fine + step - 1) // step) * step


def shardable_hb(hb_fine: int, k_size: int, n_shards: int,
                 kernel_sizes) -> bool:
    """Whether a volume of fine-grid hB ``hb_fine`` shards over
    ``n_shards``, directly or by pad-and-mask: each shard must still be at
    least one conv halo tall.  The one gate :func:`spatial_filter` enforces
    and callers (the InLoc matcher) ask first."""
    k = max(k_size, 1)
    hb_pad = padded_hb(hb_fine, k_size, n_shards)
    if hb_pad is None:
        return False
    max_halo = max(ks // 2 for ks in kernel_sizes)
    return hb_pad // n_shards // k >= max_halo


def _halo_pad(xs: List[torch.Tensor], axis: int, halo: int
              ) -> List[torch.Tensor]:
    """Each shard with its neighbours' boundary slabs along ``axis``: shard
    i prepends shard i−1's last ``halo`` slices and appends shard i+1's
    first ones, each copied to shard i's device; the outer edges get zeros
    (the unsharded 'same' padding)."""
    if halo == 0:
        return xs
    out = []
    for i, x in enumerate(xs):
        size = x.shape[axis]
        assert size >= halo, f"shard dim {size} smaller than halo {halo}"
        shape = list(x.shape)
        shape[axis] = halo
        zeros = x.new_zeros(shape)
        left = (xs[i - 1].narrow(axis, xs[i - 1].shape[axis] - halo, halo)
                .to(x.device, non_blocking=True) if i > 0 else zeros)
        right = (xs[i + 1].narrow(axis, 0, halo).to(x.device, non_blocking=True)
                 if i + 1 < len(xs) else zeros)
        out.append(torch.cat([left, x, right], dim=axis))
    return out


def _valid_rows_mask(rows_local: int, valid_rows: int, shard: int, axis: int,
                     ndim: int, device) -> torch.Tensor:
    """Boolean mask of shard ``shard``'s rows along ``axis``: True for the
    global rows below ``valid_rows`` (real data), False for the pad tail;
    1 along every other dim."""
    rows = shard * rows_local + torch.arange(rows_local, device=device)
    shape = [1] * ndim
    shape[axis] = rows_local
    return (rows < valid_rows).reshape(shape)


def _mutual_matching_sharded(corrs: List[torch.Tensor], eps: float = 1e-5,
                             masks: Optional[List[torch.Tensor]] = None
                             ) -> List[torch.Tensor]:
    """:func:`~ncnet_tpu_torch.ops.matching.mutual_matching` on the hB
    shards: the max over A is each shard's own; the max over B is the max
    of the shards' maxima (their pad rows −inf'd out by ``masks``), taken
    on the first shard's device and copied back.  A pad row's output stays
    exactly 0."""
    local_b = []
    for i, c in enumerate(corrs):
        src = c if masks is None else torch.where(
            masks[i], c, torch.full((), float("-inf"), dtype=c.dtype,
                                    device=c.device))
        local_b.append(torch.amax(src, dim=(3, 4), keepdim=True))
    home = corrs[0].device
    max_over_b = local_b[0]
    for m in local_b[1:]:
        max_over_b = torch.maximum(max_over_b, m.to(home, non_blocking=True))
    out = []
    for c in corrs:
        max_over_a = torch.amax(c, dim=(1, 2), keepdim=True)
        ratio_b = c / (max_over_a + eps)
        ratio_a = c / (max_over_b.to(c.device, non_blocking=True) + eps)
        out.append(c * (ratio_a * ratio_b))
    return out


def _zero_pad_rows(xs, masks):
    if masks is None:
        return xs
    return [torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))
            for x, m in zip(xs, masks)]


def _masks_for(xs: List[torch.Tensor], valid_rows: Optional[int], axis: int):
    if valid_rows is None:
        return None
    return [_valid_rows_mask(x.shape[axis], valid_rows, i, axis, x.ndim,
                             x.device) for i, x in enumerate(xs)]


def _nc_stack_sharded(layers: List[List[Dict[str, torch.Tensor]]],
                      xs: List[torch.Tensor], sharded_axis: int,
                      valid_rows: Optional[int] = None) -> List[torch.Tensor]:
    """[Conv4d + ReLU] × N on the shards, with a halo exchange along
    ``sharded_axis`` (1: the volume's leading spatial dim, 3: hB) before
    each layer.  ``layers[i]`` is the stack on shard i's device.  Under
    pad-and-mask the pad rows are zeroed again after every layer, so each
    conv sees zeros past the true edge, as the unsharded padding gives."""
    assert sharded_axis in (1, 3)
    masks = _masks_for(xs, valid_rows, sharded_axis)
    for j in range(len(layers[0])):
        halo = layers[0][j]["w"].shape[0] // 2
        xs = _halo_pad(xs, sharded_axis, halo)
        xs = [torch.relu(conv4d(x, stack[j]["w"], stack[j]["b"],
                                pad_ha=sharded_axis != 1,
                                pad_hb=sharded_axis != 3))
              for x, stack in zip(xs, layers)]
        xs = _zero_pad_rows(xs, masks)
    return xs


def _neigh_consensus_sharded(layers: List[List[Dict[str, torch.Tensor]]],
                             corrs: List[torch.Tensor], symmetric: bool,
                             valid_rows: Optional[int] = None
                             ) -> List[torch.Tensor]:
    """The stack-level symmetric NC filter on hB shards, the rectangular
    branch of :func:`~ncnet_tpu_torch.models.ncnet.neigh_consensus` (equal
    within float tolerance: the valid-dim convolutions sum in their own
    order).  In the tap-swap shape class (two cubic layers on a 1-channel
    input) the symmetric pass runs tap-swapped on the same shards: the
    fused first layer (1 → 2C) takes one halo exchange, and one more serves
    both second-layer convs.  Otherwise the transposed pass swaps
    (hA, wA) ↔ (hB, wB), moving the shards to the leading dim, and
    exchanges its halos there."""
    xs = [c[..., None] for c in corrs]
    if symmetric and tap_swap_fusable(layers[0]):
        fused = [tap_swap_fused_layers(stack) for stack in layers]
        ys = _nc_stack_sharded([[f[0]] for f in fused], xs, 3, valid_rows)
        halo = fused[0][1]["w"].shape[2] // 2
        ys = _halo_pad(ys, 3, halo)
        out = []
        for y, (_, l2, l2s) in zip(ys, fused):
            c = l2["w"].shape[4]
            out.append(
                torch.relu(conv4d(y[..., :c], l2["w"], l2["b"], pad_hb=False))
                + torch.relu(conv4d(y[..., c:], l2s["w"], l2s["b"],
                                    pad_hb=False)))
        out = _zero_pad_rows(out, _masks_for(out, valid_rows, 3))
        return [o[..., 0] for o in out]
    out = _nc_stack_sharded(layers, xs, 3, valid_rows)
    if symmetric:
        xts = [x.permute(0, 3, 4, 1, 2, 5) for x in xs]
        yts = _nc_stack_sharded(layers, xts, 1, valid_rows)
        out = [o + yt.permute(0, 3, 4, 1, 2, 5) for o, yt in zip(out, yts)]
    return [o[..., 0] for o in out]


def _filter_shards(config: ModelConfig, layers, corrs: List[torch.Tensor],
                   valid_rows: Optional[int]):
    """[maxpool4d] → MutualMatching → NC → MutualMatching on one pair
    group's hB shards; returns the filtered shards and their offsets."""
    k = config.relocalization_k_size
    deltas = None
    if k > 1:
        pooled = [maxpool4d_with_argmax(c, k) for c in corrs]
        corrs = [p[0] for p in pooled]
        deltas = [p[1] for p in pooled]
    masks = _masks_for(corrs, valid_rows, 3)
    corrs = _mutual_matching_sharded(corrs, masks=masks)
    corrs = _neigh_consensus_sharded(layers, corrs, config.symmetric_mode,
                                     valid_rows)
    corrs = _mutual_matching_sharded(corrs, masks=masks)
    return corrs, deltas


def _gather(shards: List[torch.Tensor], device, valid_rows: Optional[int]
            ) -> torch.Tensor:
    """The shards joined along hB on ``device``, the pad tail cut off."""
    out = torch.cat([s.to(device, non_blocking=True) for s in shards], dim=3)
    return out if valid_rows is None else out[:, :, :, :valid_rows]


def _plan(config: ModelConfig, hb: int, n_shards: int):
    """``(hb_pad, valid_rows)`` of a fine-grid hB over ``n_shards``:
    ``valid_rows`` is the pooled grid's real row count under
    pad-and-mask, else None.  Raises where the volume does not shard."""
    k = config.relocalization_k_size
    if not shardable_hb(hb, k, n_shards, config.ncons_kernel_sizes):
        raise ValueError(
            f"hB={hb} cannot shard over {n_shards} spatial shards (needs "
            f"hB divisible by k={max(k, 1)} and post-pad shards ≥ the conv "
            "halo); use fewer shards for this volume")
    hb_pad = padded_hb(hb, k, n_shards)
    return hb_pad, (hb // max(k, 1) if hb_pad > hb else None)


def _nc_layers(config: ModelConfig, params, devices) -> List[List[Dict]]:
    """The NC stack (bf16 under ``half_precision``) on each shard's device,
    one copy a distinct device."""
    nc = params["nc"]
    if config.half_precision:
        nc = params_to(nc, torch.bfloat16)
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = params_to(nc, d)
    return [copies[d] for d in devices]


def _pair_groups(mesh: Mesh, batch: int):
    """``(devices, lo, hi)`` of each pair group: the batch split in
    contiguous parts over the mesh's data axis, as JAX's ``P('data')``
    shards it."""
    n = mesh.shape["data"]
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over data={n}")
    per = batch // n
    return [(mesh.row(d), d * per, (d + 1) * per) for d in range(n)]


def _filter_groups(config: ModelConfig, params, mesh: Mesh, batch: int,
                   shards_of, valid_rows: Optional[int], home) -> NCNetOutput:
    """The loop both entry points share: each pair group's hB shards,
    ``shards_of(devices, lo, hi)`` (one a device), filtered and joined
    back whole on ``home``, the pad tail cut off."""
    corrs, deltas = [], []
    for devices, lo, hi in _pair_groups(mesh, batch):
        filtered, delta = _filter_shards(
            config, _nc_layers(config, params, devices),
            shards_of(devices, lo, hi), valid_rows)
        corrs.append(_gather(filtered, home, valid_rows))
        if delta is not None:
            deltas.append([_gather([d[i] for d in delta], home, valid_rows)
                           for i in range(4)])
    corr = torch.cat(corrs, dim=0)
    if not deltas:
        return NCNetOutput(corr, None)
    return NCNetOutput(corr, tuple(torch.cat(parts, dim=0)
                                   for parts in zip(*deltas)))


def spatial_filter(config: ModelConfig, params, corr: torch.Tensor,
                   mesh: Mesh) -> NCNetOutput:
    """The post-correlation pipeline ([maxpool4d] → MutualMatching →
    NeighConsensus → MutualMatching) with the volume split over hB across
    the mesh's ``spatial`` axis: the sharded twin of
    :func:`~ncnet_tpu_torch.models.ncnet.ncnet_filter`.  ``corr`` is the
    whole ``(B, hA, wA, hB, wB)`` volume; its hB rows are padded (pad-and-
    mask, where hB does not divide over ``n_shards·k``), split and copied
    to the shards' devices, and the result comes back whole on ``corr``'s
    device, the pad tail cut off."""
    n_shards = mesh.shape[SPATIAL_AXIS]
    hb_pad, valid_rows = _plan(config, corr.shape[3], n_shards)
    if hb_pad > corr.shape[3]:
        corr = torch.nn.functional.pad(corr, (0, 0, 0, hb_pad - corr.shape[3]))
    if config.half_precision:
        corr = corr.to(torch.bfloat16)
    rows = hb_pad // n_shards
    return _filter_groups(
        config, params, mesh, corr.shape[0],
        lambda devices, lo, hi: [
            corr[lo:hi, :, :, i * rows:(i + 1) * rows].to(d)
            for i, d in enumerate(devices)],
        valid_rows, corr.device)


def spatial_correlation(fa: torch.Tensor, fb: torch.Tensor,
                        devices) -> List[torch.Tensor]:
    """The 4D correlation born split over hB: shard i is
    ``correlation_4d(fa, fb_i)`` on ``devices[i]``, where ``fb_i`` is
    shard i's equal share of ``fb``'s rows and ``fa`` is copied whole to
    every shard (bf16 features multiply with f32 sums, as
    ``ops/correlation.py``)."""
    n = len(devices)
    if fb.shape[1] % n:
        raise ValueError(f"hB={fb.shape[1]} does not split over {n} shards")
    rows = fb.shape[1] // n
    fa_on = {}
    out = []
    for i, d in enumerate(devices):
        if d not in fa_on:
            fa_on[d] = fa.to(d, non_blocking=True)
        out.append(correlation_4d(
            fa_on[d], fb[:, i * rows:(i + 1) * rows].to(d, non_blocking=True)))
    return out


def spatial_forward(config: ModelConfig, params, source_images: torch.Tensor,
                    target_images: torch.Tensor, mesh: Mesh) -> NCNetOutput:
    """The full forward with an hB-sharded volume, the twin of
    :func:`~ncnet_tpu_torch.models.ncnet.ncnet_forward`: the trunk runs
    once, on the images' device (the features are ~3 orders of magnitude
    smaller than the volume); each pair group's target rows are
    zero-padded to the shardable hB (zero rows correlate to exactly zero)
    and the volume is born sharded (:func:`spatial_correlation`); the
    filtered volume comes back whole on the images' device."""
    fa = extract_features(config, params, source_images)
    fb = extract_features(config, params, target_images)
    if config.half_precision:
        fa, fb = fa.to(torch.bfloat16), fb.to(torch.bfloat16)
    n_shards = mesh.shape[SPATIAL_AXIS]
    hb = fb.shape[1]
    hb_pad, valid_rows = _plan(config, hb, n_shards)
    if hb_pad > hb:
        fb = torch.nn.functional.pad(fb, (0, 0, 0, 0, 0, hb_pad - hb))
    return _filter_groups(
        config, params, mesh, fa.shape[0],
        lambda devices, lo, hi: spatial_correlation(fa[lo:hi], fb[lo:hi],
                                                    devices),
        valid_rows, source_images.device)
