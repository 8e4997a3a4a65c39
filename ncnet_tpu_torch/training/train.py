"""The training step (``ncnet_tpu/training/train.py``): Adam over the
trainable partition, the NaN guard, and the epoch loop.

The JAX step is one jitted program with donated state; here it is eager
PyTorch, with the same contract: ``step(state, batch) → (state, loss)``.
The state is a :class:`TrainState` of plain trees (dicts and lists of
tensors), and the optimizer is a functional Adam written over that tree,
equal to ``optax.multi_transform({"trainable": optax.adam(lr), "frozen":
optax.set_to_zero()}, labels)``: its state is ``count`` and the moments
``mu``, ``nu`` of the trainable leaves (None at frozen ones), so the NaN
guard can keep the old state by keeping the old tree.

``fit`` (checkpoints, resume, preemption, telemetry) and the CLI are a
later slice; this one takes batches of numpy arrays or tensors.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ncnet_tpu_torch.config import ModelConfig, TrainConfig
from ncnet_tpu_torch.models import backbone as bb
from ncnet_tpu_torch.models.ncnet import (
    check_ported,
    init_ncnet,
    params_to,
    resolve_device,
    tree_leaves,
    tree_map,
)
from ncnet_tpu_torch.training.loss import weak_loss, weak_loss_and_grads

log = logging.getLogger("ncnet_tpu_torch.training")


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def check_train_ported(config: TrainConfig) -> None:
    """Raise ``NotImplementedError`` naming the first option of ``config``
    that this slice of the port does not run (and ``check_ported`` for its
    model)."""
    unported = [
        ("fe_finetune_params", config.fe_finetune_params > 0),
        ("finetune_cp_rank", config.finetune_cp_rank > 0),
        # the step functions take these NC-stack knobs (neigh_consensus
        # runs them); the recipe keeps them at their defaults until the
        # fit slice ports the rest of the recipe
        ("remat_nc_layers", config.remat_nc_layers),
        ("nc_custom_grad", config.nc_custom_grad),
        ("nc_pallas_vjp", not config.nc_pallas_vjp),
        ("distributed", config.distributed),
    ]
    for name, hit in unported:
        if hit:
            raise NotImplementedError(
                f"TrainConfig.{name}={getattr(config, name)!r} is not ported "
                "to ncnet_tpu_torch yet")
    check_ported(config.model)


def trainable_labels(config: ModelConfig, params, fe_finetune_params: int = 0):
    """'trainable'/'frozen' labels: the consensus stack always trains; the
    last ``fe_finetune_params`` trunk blocks optionally join."""
    return {
        "backbone": bb.finetune_labels(config.backbone, params["backbone"],
                                       fe_finetune_params),
        "nc": tree_map(lambda _: "trainable", params["nc"]),
    }


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    count: torch.Tensor   # int32 scalar: updates taken
    mu: Any               # first moments (None at frozen leaves)
    nu: Any               # second moments (None at frozen leaves)


class Adam:
    """``optax.adam(lr)`` over the ``'trainable'`` leaves and
    ``optax.set_to_zero()`` over the ``'frozen'`` ones, as functions of
    the state: ``mu ← (1−b1)·g + b1·mu``, ``nu ← (1−b2)·g² + b2·nu``,
    ``count ← count + 1``, update ``−lr · m̂ / (√(v̂ + eps_root) + eps)``
    with the bias corrections ``1 − b^count`` taken in f32.  Frozen leaves
    get no update (None)."""

    def __init__(self, lr: float, labels, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.lr, self.labels = lr, labels
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params) -> AdamState:
        def zeros(p, label):
            return torch.zeros_like(p) if label == "trainable" else None

        first = tree_leaves(params)[0]
        return AdamState(
            torch.zeros((), dtype=torch.int32, device=first.device),
            tree_map(zeros, params, self.labels),
            tree_map(zeros, params, self.labels))

    def update(self, grads, state: AdamState, params=None):
        """``(updates, new_state)``; updates are None at frozen leaves."""
        b1, b2 = self.b1, self.b2

        def moment(g, m, label, decay, order):
            if label != "trainable":
                return None
            return (1 - decay) * g ** order + decay * m

        mu = tree_map(lambda g, m, lab: moment(g, m, lab, b1, 1),
                      grads, state.mu, self.labels)
        nu = tree_map(lambda g, v, lab: moment(g, v, lab, b2, 2),
                      grads, state.nu, self.labels)
        count = state.count + 1
        n = count.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=n.device) ** n
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=n.device) ** n

        def step(m, v):
            m_hat = m / bc1.to(m.dtype)
            v_hat = v / bc2.to(v.dtype)
            return -self.lr * (m_hat / (torch.sqrt(v_hat + self.eps_root)
                                        + self.eps))

        return tree_map(step, mu, nu), AdamState(count, mu, nu)


def make_optimizer(labels) -> Callable[[float], Adam]:
    """An ``lr → optimizer`` factory bound to the trainable/frozen label
    tree (the JAX function's contract)."""
    return lambda lr: Adam(lr, labels)


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, in each param's dtype; a leaf
    without an update (None) is kept as it is."""
    def add(p, u):
        return p if u is None else (p + u).to(p.dtype)

    return tree_map(add, params, updates)


def create_train_state(config: TrainConfig, seed: Optional[int] = None,
                       device=None):
    """Random params from ``seed`` (default ``config.seed``) and a fresh
    Adam, on ``device`` (CUDA unless another is given).  Returns ``(state,
    optimizer, model_config, labels)``."""
    check_train_ported(config)
    dev = resolve_device(device)
    model_config = config.model
    params = params_to(
        init_ncnet(model_config, config.seed if seed is None else seed), dev)
    labels = trainable_labels(model_config, params, config.fe_finetune_params)
    optimizer = make_optimizer(labels)(config.lr)
    return (TrainState(params, optimizer.init(params), 0), optimizer,
            model_config, labels)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v
                               ).to(device)
            for k, v in batch.items()}


def _value_and_grad(loss_fn, params, trainable):
    """``loss_fn(params)`` and its gradient at every leaf ``trainable``
    selects; zeros elsewhere (the JAX ``value_and_grad`` over the whole
    tree, where those leaves get zero gradient)."""
    leaves = tree_map(lambda p, t: p.detach().requires_grad_() if t else p,
                      params, trainable)
    with torch.enable_grad():
        loss = loss_fn(leaves)
    flat = [p for p, t in zip(tree_leaves(leaves), tree_leaves(trainable)) if t]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))

    def grad(p, t):
        if not t:
            return torch.zeros_like(p)
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad, leaves, trainable)


def make_train_step(model_config: ModelConfig, optimizer: Adam,
                    donate: bool = True, stop_backbone_grad: bool = False,
                    remat_nc_layers: bool = False,
                    nc_custom_grad: bool = False, fold_pos_neg: bool = False,
                    remat_filter: bool = True, accum_chunks: int = 0,
                    nan_guard: bool = False, nc_pallas_vjp: bool = True,
                    with_grad_norm: bool = False):
    """``step(state, batch) → (state, loss)`` (``(state, loss, grad_norm)``
    with ``with_grad_norm``), with the JAX function's arguments.

    ``accum_chunks != 0`` (frozen trunk only) takes the chunked
    :func:`weak_loss_and_grads`; ``0`` differentiates :func:`weak_loss`
    over the whole batch (over the NC stack only when
    ``stop_backbone_grad``, else over every leaf).  ``nan_guard`` checks
    the loss and every update leaf: if any is not finite, the params and
    the Adam state are kept, ``step`` still advances, and the loss is
    reported as NaN (one host sync per step).  ``donate`` has no
    counterpart in eager PyTorch: the step builds new leaves for the
    trained parameters and shares the frozen ones, so the old state stays
    valid."""
    if accum_chunks != 0 and not stop_backbone_grad:
        raise ValueError(
            "accum_chunks requires the frozen trunk (fe_finetune_params=0): "
            "chunked accumulation detaches the features")
    del donate

    def step(state: TrainState, batch):
        dev = tree_leaves(state.params["nc"])[0].device
        batch = _to_device(batch, dev)
        if accum_chunks != 0:
            loss, grads = weak_loss_and_grads(
                model_config, state.params, batch, accum_chunks=accum_chunks,
                remat_nc_layers=remat_nc_layers,
                nc_custom_grad=nc_custom_grad, nc_pallas_vjp=nc_pallas_vjp)
        else:
            trainable = {
                "backbone": tree_map(lambda _: not stop_backbone_grad,
                                     state.params["backbone"]),
                "nc": tree_map(lambda _: True, state.params["nc"])}
            loss, grads = _value_and_grad(
                lambda p: weak_loss(
                    model_config, p, batch,
                    stop_backbone_grad=stop_backbone_grad,
                    remat_nc_layers=remat_nc_layers,
                    nc_custom_grad=nc_custom_grad, fold_pos_neg=fold_pos_neg,
                    remat_filter=remat_filter, nc_pallas_vjp=nc_pallas_vjp),
                state.params, trainable)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = apply_updates(state.params, updates)
        if nan_guard:
            ok = torch.isfinite(loss)
            for u in tree_leaves(updates):
                ok = ok & torch.isfinite(u).all()
            if not bool(ok):
                params, opt_state = state.params, state.opt_state
                loss = torch.full_like(loss, math.nan)
        new_state = TrainState(params, opt_state, state.step + 1)
        if with_grad_norm:
            norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                                  for g in tree_leaves(grads)))
            return new_state, loss, norm
        return new_state, loss

    return step


def make_eval_step(model_config: ModelConfig):
    """``eval_step(params, batch) → loss``: :func:`weak_loss` without
    gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        dev = tree_leaves(params["nc"])[0].device
        return weak_loss(model_config, params, _to_device(batch, dev))

    return eval_step


def process_epoch(mode: str, epoch: int, state: TrainState, step_fn,
                  loader: Iterable[Dict[str, Any]], log_interval: int = 1,
                  put_batch: Optional[Callable] = None
                  ) -> Tuple[TrainState, float]:
    """One pass over ``loader`` (any iterable of batch dicts with
    ``source_image``/``target_image``); ``mode`` is ``"train"`` (``step_fn
    (state, batch)``) or ``"eval"`` (``step_fn(params, batch)``).  Returns
    the state and the epoch's mean loss.  In train mode the non-finite
    losses of guarded-away steps are left out of the mean (and counted);
    in eval mode a non-finite loss keeps the mean non-finite.
    ``put_batch`` maps each image array onto the device (default: the
    params' device)."""
    dev = tree_leaves(state.params["nc"])[0].device
    put_batch = put_batch or (lambda a: torch.as_tensor(np.asarray(a)).to(dev))
    losses = []
    for batch_idx, batch in enumerate(loader):
        images = {"source_image": put_batch(batch["source_image"]),
                  "target_image": put_batch(batch["target_image"])}
        if mode == "train":
            state, loss = step_fn(state, images)[:2]
        else:
            loss = step_fn(state.params, images)
        loss = float(loss)
        losses.append(loss)
        if batch_idx % log_interval == 0:
            log.info(f"{mode.capitalize()} Epoch: {epoch} [{batch_idx}]\t\t"
                     f"Loss: {loss:.6f}")
    if not losses:
        raise ValueError(f"{mode} loader is empty: refusing to report a fake "
                         "epoch loss")
    arr = np.asarray(losses, np.float64)
    if mode == "train":
        finite = np.isfinite(arr)
        if not finite.all():
            log.info(f"{mode.capitalize()} set: excluded "
                     f"{int((~finite).sum())} non-finite step loss(es) from "
                     "the epoch mean")
        epoch_loss = float(arr[finite].mean()) if finite.any() else math.nan
    else:
        epoch_loss = float(arr.mean())
    log.info(f"{mode.capitalize()} set: Average loss: {epoch_loss:.4f}")
    return state, epoch_loss
