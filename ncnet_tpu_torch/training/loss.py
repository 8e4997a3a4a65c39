"""Weakly-supervised matching loss (``ncnet_tpu/training/loss.py``).

Score a pair as the mean (over cells, both directions) of the max
normalized match value; loss = score(negative) − score(positive), where the
negatives pair each target with the *next* source in the batch (the
reference's in-batch roll, train.py:137).  Features are extracted once: the
rolled negatives' source features are the positives' rolled along the
batch.

Dtypes follow the JAX package at every point: under ``half_precision`` the
volume, the softmax, max and mean run in bf16 (sums inside them in f32),
and the chunked loss weights the bf16 pair scores with f32 weights.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ncnet_tpu_torch.config import ModelConfig
from ncnet_tpu_torch.models.ncnet import (
    extract_features,
    ncnet_filter,
    tree_map,
)
from ncnet_tpu_torch.ops.correlation import correlation_4d


def _softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``'s forward in the input's dtype: ``exp`` rounded
    to it, the sum accumulated in f32 and rounded, then the division."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True).detach())
    return e / e.sum(dim=dim, keepdim=True)


def _normalize(x: torch.Tensor, dim: int, normalization) -> torch.Tensor:
    if normalization == "softmax":
        return _softmax(x, dim)
    if normalization == "l1":
        return x / (x.sum(dim=dim, keepdim=True) + 1e-4)
    if normalization is None or normalization == "none":
        return x
    raise ValueError(f"unknown normalization {normalization!r}")


def match_score_per_pair(corr: torch.Tensor,
                         normalization: str = "softmax") -> torch.Tensor:
    """Per-pair best-match score of a filtered ``(B, hA, wA, hB, wB)``
    volume, averaged over both matching directions (train.py:125-134);
    returns ``(B,)``."""
    b, ha, wa, hb, wb = corr.shape
    # B→A: a distribution over A cells for each B cell; A→B: over B cells
    nc_b = _normalize(corr.reshape(b, ha * wa, hb, wb), 1, normalization)
    nc_a = _normalize(corr.reshape(b, ha, wa, hb * wb), 3, normalization)
    scores_b = torch.amax(nc_b, dim=1).mean(dim=(1, 2))
    scores_a = torch.amax(nc_a, dim=3).mean(dim=(1, 2))
    return (scores_a + scores_b) / 2.0


def match_score(corr: torch.Tensor, normalization: str = "softmax"
                ) -> torch.Tensor:
    """Batch mean of :func:`match_score_per_pair`."""
    return match_score_per_pair(corr, normalization).mean()


def _features(config: ModelConfig, params, batch, detach: bool):
    fa = extract_features(config, params, batch["source_image"])
    fb = extract_features(config, params, batch["target_image"])
    if detach:
        fa, fb = fa.detach(), fb.detach()
    if config.half_precision:
        fa, fb = fa.to(torch.bfloat16), fb.to(torch.bfloat16)
    return fa, fb


def weak_loss(config: ModelConfig, params, batch: Dict[str, torch.Tensor],
              normalization: str = "softmax",
              stop_backbone_grad: bool = False,
              remat_nc_layers: bool = False, nc_custom_grad: bool = False,
              fold_pos_neg: bool = False, remat_filter: bool = True,
              nc_pallas_vjp: bool = True) -> torch.Tensor:
    """score(negative) − score(positive) on an image-pair batch
    (``source_image``/``target_image`` of shape ``(B, H, W, 3)``).

    ``stop_backbone_grad`` detaches the features (the frozen trunk);
    ``fold_pos_neg`` runs both volume sets through one filter call of 2B;
    ``remat_filter`` recomputes the filter in the backward
    (``torch.utils.checkpoint``, non-reentrant) when autograd records;
    ``nc_pallas_vjp`` is passed to ``ncnet_filter`` as both ``nc_pallas``
    and ``nc_pallas_vjp``, as the JAX package does.  ``remat_nc_layers``
    (a checkpoint per NC layer) and ``nc_custom_grad`` (the routed
    ``conv4d_same`` backward) are :func:`neigh_consensus`'s memory knobs."""
    fa, fb = _features(config, params, batch, stop_backbone_grad)

    def filt(corr):
        return ncnet_filter(config, params, corr,
                            remat_nc_layers=remat_nc_layers,
                            nc_custom_grad=nc_custom_grad,
                            nc_pallas=nc_pallas_vjp,
                            nc_pallas_vjp=nc_pallas_vjp).corr

    if remat_filter and torch.is_grad_enabled():
        run = lambda corr: checkpoint(filt, corr, use_reentrant=False)  # noqa: E731
    else:
        run = filt
    corr_pos = correlation_4d(fa, fb)
    corr_neg = correlation_4d(torch.roll(fa, -1, dims=0), fb)
    if fold_pos_neg:
        b = corr_pos.shape[0]
        scores = match_score_per_pair(
            run(torch.cat([corr_pos, corr_neg], dim=0)), normalization)
        return scores[b:].mean() - scores[:b].mean()
    score_pos = match_score(run(corr_pos), normalization)
    score_neg = match_score(run(corr_neg), normalization)
    return score_neg - score_pos


def auto_accum_chunks(batch_size: int, n_dev: int = 1) -> int:
    """Chunk count for :func:`weak_loss_and_grads`: a chunk of four volumes
    (the JAX package's choice), rounded so that the chunk size is a
    multiple of ``n_dev`` dividing ``2 * batch_size``; else one chunk."""
    n2 = 2 * batch_size
    target = max(4, n_dev)
    for c in list(range(target, n_dev - 1, -1)) + list(range(target + 1, n2)):
        if c > 0 and n2 % c == 0 and c % n_dev == 0:
            return n2 // c
    return 1


def weak_loss_and_grads(config: ModelConfig, params,
                        batch: Dict[str, torch.Tensor],
                        normalization: str = "softmax",
                        accum_chunks: int = -1,
                        remat_nc_layers: bool = False,
                        nc_custom_grad: bool = False,
                        nc_pallas_vjp: bool = True) -> Tuple[torch.Tensor, Dict]:
    """:func:`weak_loss`'s value and parameter gradients with the trunk
    frozen, by volume-chunked accumulation (``loss.py:188``).

    The loss is linear in the per-volume scores: B positives weighted −1/B
    and B rolled negatives weighted +1/B.  Features are extracted once
    without gradient; the 2B volumes are walked in ``accum_chunks`` chunks
    (``-1``: :func:`auto_accum_chunks`), each one's filter forward and
    backward in turn, and the NC gradients summed in f32 (the JAX scan, as
    a Python loop).  Trunk gradients come back as zeros, as JAX returns
    them.  Requires ``2 * B % accum_chunks == 0``."""
    with torch.no_grad():
        fa, fb = _features(config, params, batch, detach=True)
    b = fa.shape[0]
    n2 = 2 * b
    if accum_chunks == -1:
        accum_chunks = auto_accum_chunks(b)
    if n2 % accum_chunks:
        raise ValueError(f"accum_chunks={accum_chunks} must divide 2*batch={n2}")
    fa2 = torch.cat([fa, torch.roll(fa, -1, dims=0)], dim=0)
    fb2 = torch.cat([fb, fb], dim=0)
    w2 = torch.cat([torch.full((b,), -1.0 / b), torch.full((b,), 1.0 / b)]
                   ).to(device=fa.device, dtype=torch.float32)
    nc = params["nc"]
    c = n2 // accum_chunks
    loss = torch.zeros((), dtype=torch.float32, device=fa.device)
    g_nc: List[Dict[str, torch.Tensor]] = [
        {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
         for k, v in layer.items()} for layer in nc]
    for i in range(accum_chunks):
        leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()}
                  for layer in nc]
        with torch.enable_grad():
            vol = ncnet_filter(
                config, {**params, "nc": leaves},
                correlation_4d(fa2[i * c:(i + 1) * c], fb2[i * c:(i + 1) * c]),
                remat_nc_layers=remat_nc_layers,
                nc_custom_grad=nc_custom_grad, nc_pallas=nc_pallas_vjp,
                nc_pallas_vjp=nc_pallas_vjp).corr
            val = (match_score_per_pair(vol, normalization)
                   * w2[i * c:(i + 1) * c]).sum()
        flat = [t for layer in leaves for t in layer.values()]
        grads = torch.autograd.grad(val, flat)
        it = iter(grads)
        for layer in g_nc:
            for k in layer:
                layer[k] += next(it).to(torch.float32)
        loss = loss + val.detach()
    grads = {**tree_map(torch.zeros_like,
                        {k: v for k, v in params.items() if k != "nc"}),
             "nc": g_nc}
    return loss, grads
