"""Training (``ncnet_tpu/training/train.py``): Adam over the trainable
partition, the NaN guard, the epoch loop, versioned checkpoints and
``fit``, the reference train.py flow (train.py:161-205: epochs over
``train_pairs.csv``, the val loss each epoch, a checkpoint every epoch and
a ``best_`` copy on improvement).

The JAX step is one jitted program with donated state; here it is eager
PyTorch with the same contract: ``step(state, batch) → (state, loss)``.
The state is a :class:`TrainState` of plain trees (dicts and lists of
tensors), and the optimizer is a functional Adam written over that tree,
equal to ``optax.multi_transform({"trainable": optax.adam(lr), "frozen":
optax.set_to_zero()}, labels)``: its state is ``count`` and the moments
``mu``, ``nu`` of the trainable leaves (None at frozen ones).

Fault tolerance, as in the JAX package:

**Checkpoint layout.** ``fit`` writes a versioned root::

    <result_model_dir>/<stamp>_<name>/       # the root; result["checkpoint"]
        step_00000004/                       # a committed version
            config.json   # ModelConfig + _train/_epoch/_step/_position/loss keys
            params/params.pt   # the params tree (models/checkpoint.py, D5)
            opt/opt.pt         # {"opt_state": Adam state as a dict, "step"}
        step_00000006.tmp/                   # a crashed save: ignored, reclaimed
    <result_model_dir>/best_<stamp>_<name>/  # flat copy of the best version

Every version is written to ``step_<N>.tmp`` and committed by one rename;
retention keeps the newest ``keep_checkpoints`` versions (the ``best_`` copy
is never pruned); saves and loads retry transient I/O errors.

**Resume.** Point ``model.checkpoint`` at the root (or a version, or the
``best_`` copy): the newest complete version's params, Adam state, step
and loader position (``_position`` = ``{"epoch": E, "next_batch": B}``) are
restored.  The epoch-keyed shuffle and the per-``(seed, epoch, idx)``
crops make the skip deterministic, so a resumed run ends bit-equal to an
uninterrupted one.  A root written by ``fit`` continues in place.

**Guards.** With ``nan_guard`` the step keeps a non-finite update out of
the params and the Adam state on the card (``torch.where``, no host
decision inside the step); the host counts consecutive skips from the
one loss it fetches a step and raises :class:`TrainDivergedError` after
``max_bad_steps``.  SIGTERM/SIGINT request a checkpoint at the next step
boundary and a clean return (``result["preempted"]``).

**Data parallelism** (ROADMAP D7): one process a GPU under
``torch.distributed`` (``fit``'s docstring), where the JAX package
shards the pair axis over one process's devices.  Its
``guarded_train_step`` (tier demotion after a device failure, dropped by
decision D4) has no counterpart: a device failure propagates, and
resuming from the last committed version is the recovery.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ncnet_tpu_torch.config import ModelConfig, TrainConfig
from ncnet_tpu_torch.data import DataLoader, ImagePairDataset
from ncnet_tpu_torch.data.loader import stage_array
from ncnet_tpu_torch.models import backbone as bb
from ncnet_tpu_torch.models import checkpoint as ckpt_io
from ncnet_tpu_torch.models.ncnet import (
    check_ported,
    extract_features,
    init_ncnet,
    params_to,
    resolve_device,
    tree_leaves,
    tree_map,
)
from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.observability import get_logger
from ncnet_tpu_torch.observability.device import DeviceMonitor, Heartbeat
from ncnet_tpu_torch.observability.events import EventLog
from ncnet_tpu_torch.observability.metrics import (
    MetricsRegistry,
    device_peak_tflops,
    train_step_flops,
)
from ncnet_tpu_torch.observability.tracing import span
from ncnet_tpu_torch.parallel import distributed as pdist
from ncnet_tpu_torch.training.loss import (
    auto_accum_chunks,
    weak_loss,
    weak_loss_and_grads,
)
from ncnet_tpu_torch.utils import faults
from ncnet_tpu_torch.utils.profiling import (
    StepWindowTracer,
    annotate,
    maybe_trace,
)

log = get_logger("training")

OPT_FILE = os.path.join("opt", "opt.pt")


class TrainDivergedError(RuntimeError):
    """``max_bad_steps`` consecutive non-finite losses: the run diverges (or
    its data is poisoned).  Params and Adam state are not corrupted: the
    NaN guard kept every bad update out."""


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def check_train_ported(config: TrainConfig) -> None:
    """Raise ``NotImplementedError`` naming the first option of ``config``
    that the port does not run: every training option runs since the
    multi-GPU slice, so only ``check_ported``'s for its model."""
    check_ported(config.model)


def trainable_labels(config: ModelConfig, params, fe_finetune_params: int = 0):
    """'trainable'/'frozen' labels: the consensus stack always trains (its
    CP factors too, when attached); the last ``fe_finetune_params`` trunk
    blocks optionally join."""
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
        # a Python base: a constant copied to the card would wait for it
        bc1 = 1 - torch.pow(b1, n)
        bc2 = 1 - torch.pow(b2, n)

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
    """Params and a fresh Adam, on ``device`` (CUDA unless another is
    given): loaded from ``config.model.checkpoint`` (a ``.pth.tar``, a
    native directory or a ``fit`` root; its architecture overrides
    ``config.model``'s), else random from ``seed`` (default
    ``config.seed``).  With ``finetune_cp_rank`` the NC kernels get rank-R
    CP factors (``ops/cp_als.py::decompose_stack``) and ``nc_tier='cp'``
    forces both directions through the CP chain, so the factors train
    (the dense kernels ride along with zero gradients).  Returns
    ``(state, optimizer, model_config, labels)``."""
    check_train_ported(config)
    dev = resolve_device(device)
    model_config = config.model
    if model_config.checkpoint:
        model_config, params = ckpt_io.load_params(model_config.checkpoint,
                                                   model_config)
        check_ported(model_config)
    else:
        params = init_ncnet(model_config, config.seed if seed is None else seed)
    if config.finetune_cp_rank > 0:
        if config.fe_finetune_params > 0:
            raise ValueError(
                "finetune_cp_rank fine-tunes CP factors with the trunk "
                "frozen (the paper's recipe); it is incompatible with "
                "fe_finetune_params > 0")
        from ncnet_tpu_torch.ops.cp_als import decompose_stack

        params = dict(params)
        params["nc"], cp_errs = decompose_stack(params["nc"],
                                                config.finetune_cp_rank)
        model_config = model_config.replace(nc_tier="cp")
        log.info(f"CP fine-tune: rank {config.finetune_cp_rank}, per-layer "
                 f"reconstruction error {[round(e, 4) for e in cp_errs]}")
        if not config.model.checkpoint:
            log.warning("finetune_cp_rank without model.checkpoint decomposes "
                        "a RANDOM init — sensible only for smoke tests")
    params = params_to(params, dev)
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
    # walked by tree_map, which pairs leaves by key: the two trees' dicts
    # may list their keys in different orders
    flat = []
    tree_map(lambda p, t: flat.append(p) if t else None, leaves, trainable)
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
                    with_grad_norm: bool = False, data_parallel: bool = False):
    """``step(state, batch) → (state, loss)`` (``(state, loss, grad_norm)``
    with ``with_grad_norm``), with the JAX function's arguments.

    ``accum_chunks != 0`` (frozen trunk only) takes the chunked
    :func:`weak_loss_and_grads`; ``0`` differentiates :func:`weak_loss`
    over the whole batch (over the NC stack only when
    ``stop_backbone_grad``, else over every leaf).  ``nan_guard`` checks
    the loss and every update leaf on the card: where any is not finite,
    ``torch.where`` keeps the old params and Adam state, ``step`` still
    advances, and the loss reads NaN; nothing waits for the card.
    ``donate`` has no counterpart in eager PyTorch: the step builds new
    leaves for the trained parameters and shares the frozen ones, so the
    old state stays valid.

    ``data_parallel`` inside a ``torch.distributed`` group: each rank's
    step takes its slice of the global batch, and its loss is its part of
    the global-batch loss (``training/loss.py``); the parts of the loss
    and of the trainable gradients (with ``with_grad_norm``, of every
    differentiated one, so the norm is the global batch's) are summed over
    the ranks by one ``all_reduce`` of one flat buffer, so every rank
    takes the same update and the NaN guard's decision, made on the
    reduced values and still on the card, is the same everywhere."""
    if accum_chunks != 0 and not stop_backbone_grad:
        raise ValueError(
            "accum_chunks requires the frozen trunk (fe_finetune_params=0): "
            "chunked accumulation detaches the features")
    del donate

    def step(state: TrainState, batch):
        dev = tree_leaves(state.params["nc"])[0].device
        batch = _to_device(batch, dev)
        # the leaves the loss is differentiated at (zeros elsewhere)
        differentiated = {
            "backbone": tree_map(lambda _: not stop_backbone_grad,
                                 state.params["backbone"]),
            "nc": tree_map(lambda _: True, state.params["nc"])}
        if accum_chunks != 0:
            loss, grads = weak_loss_and_grads(
                model_config, state.params, batch, accum_chunks=accum_chunks,
                remat_nc_layers=remat_nc_layers,
                nc_custom_grad=nc_custom_grad, nc_pallas_vjp=nc_pallas_vjp,
                data_parallel=data_parallel)
        else:
            loss, grads = _value_and_grad(
                lambda p: weak_loss(
                    model_config, p, batch,
                    stop_backbone_grad=stop_backbone_grad,
                    remat_nc_layers=remat_nc_layers,
                    nc_custom_grad=nc_custom_grad, fold_pos_neg=fold_pos_neg,
                    remat_filter=remat_filter, nc_pallas_vjp=nc_pallas_vjp,
                    data_parallel=data_parallel),
                state.params, differentiated)
        if data_parallel and pdist.is_initialized():
            # the update reads the trainable leaves; the norm reads every
            # differentiated one (a fine-tuned trunk's frozen leaves too)
            summed = tree_map(
                lambda lab, d: lab == "trainable" or (with_grad_norm and d),
                optimizer.labels, differentiated)
            loss, grads = all_reduce_sum(loss, grads, summed)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = apply_updates(state.params, updates)
        if nan_guard:
            # the loss AND every update leaf: a backward overflow can give
            # non-finite updates under a finite loss
            ok = torch.isfinite(loss)
            for u in tree_leaves(updates):
                ok = ok & torch.isfinite(u).all()

            def keep(new, old):
                return torch.where(ok, new, old)

            params = tree_map(lambda new, old, u: old if u is None
                              else keep(new, old),
                              params, state.params, updates)
            opt_state = AdamState(
                keep(opt_state.count, state.opt_state.count),
                tree_map(keep, opt_state.mu, state.opt_state.mu),
                tree_map(keep, opt_state.nu, state.opt_state.nu))
            loss = torch.where(ok, loss, torch.full_like(loss, math.nan))
        new_state = TrainState(params, opt_state, state.step + 1)
        if with_grad_norm:
            norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                                  for g in tree_leaves(grads)))
            return new_state, loss, norm
        return new_state, loss

    return step


def all_reduce_sum(loss: torch.Tensor, grads, summed):
    """The loss and the leaves of ``grads`` that the bool tree ``summed``
    selects, summed over the process group by one ``all_reduce`` of one
    flat f32 buffer; the other leaves are returned as they are (this
    rank's part, read by nothing after the step)."""
    picked = []
    tree_map(lambda g, s: picked.append(g) if s else None, grads, summed)
    flat = torch.cat([loss.reshape(1).to(torch.float32)]
                     + [g.reshape(-1).to(torch.float32) for g in picked])
    dist.all_reduce(flat)
    parts = iter(torch.split(flat, [1] + [g.numel() for g in picked]))
    total = next(parts).reshape(loss.shape).to(loss.dtype)
    reduced = {id(g): p.reshape(g.shape).to(g.dtype)
               for g, p in zip(picked, parts)}
    return total, tree_map(lambda g: reduced.get(id(g), g), grads)


def make_eval_step(model_config: ModelConfig, data_parallel: bool = False):
    """``eval_step(params, batch) → loss``: :func:`weak_loss` without
    gradients; under ``data_parallel`` in a process group, the global
    batch's loss (the ranks' parts summed)."""

    @torch.no_grad()
    def eval_step(params, batch):
        dev = tree_leaves(params["nc"])[0].device
        loss = weak_loss(model_config, params, _to_device(batch, dev),
                         data_parallel=data_parallel)
        if data_parallel and pdist.is_initialized():
            dist.all_reduce(loss)
        return loss

    return eval_step


def process_epoch(mode: str, epoch: int, state: TrainState, step_fn,
                  loader: Iterable[Dict[str, Any]], log_interval: int = 1,
                  put_batch: Optional[Callable] = None, step_base: int = 0,
                  on_step: Optional[Callable[[int, TrainState, float], bool]]
                  = None,
                  telemetry_ctx: Optional[Dict[str, Any]] = None
                  ) -> Tuple[TrainState, float]:
    """One pass over ``loader`` (any sized iterable of batch dicts with
    ``source_image``/``target_image``); ``mode`` is ``"train"``
    (``step_fn(state, batch)``) or ``"test"`` (``step_fn(params,
    batch)``).  Mirrors the reference's per-batch log lines
    (train.py:161-181).  Returns the state and the epoch's mean loss.

    ``put_batch`` maps a host array onto the card (default
    ``data/loader.py::stage_array`` to the params' device).  Staging is double
    buffered: step N is dispatched, batch N+1 is staged, then step N's
    loss is fetched, the one place a step waits for the card (with the
    grad norm in the same copy).  ``on_step(batch_idx, state, loss)`` runs
    after every train step with that float; returning True ends the epoch
    early.  ``step_base`` is the global step count entering this epoch;
    the loader's ``start_batch`` (mid-epoch resume) is read back for
    global batch indexing.  In train mode the non-finite losses of
    guarded-away steps are left out of the mean (and counted); in test
    mode a non-finite loss keeps the mean non-finite.

    Telemetry: with an event sink bound, every train step emits a
    ``step`` event (loss, ``wall_s``, ``stage_wall_s``, ``pairs_per_s``,
    ``grad_norm``, ``mfu_pct`` when ``telemetry_ctx`` carries
    ``flops_per_pair`` and ``peak_tflops``) and a ``quality`` event (the
    pos/neg ``score_gap``, tagged with the backward's tier); a
    ``registry`` in ``telemetry_ctx`` accumulates the same numbers and a
    ``tracer`` (:class:`StepWindowTracer`) is fed each global step."""
    dev = tree_leaves(state.params["nc"])[0].device
    put_batch = put_batch or (lambda a: stage_array(a, dev))
    ctx = telemetry_ctx or {}
    tracer: Optional[StepWindowTracer] = ctx.get("tracer")
    registry: Optional[MetricsRegistry] = ctx.get("registry")
    n = len(loader)
    if n == 0:
        raise ValueError(
            f"{mode} loader is empty (dataset smaller than batch_size with "
            "drop_last) — refusing to report a fake 0.0 epoch loss")
    start_batch = getattr(loader, "start_batch", 0)
    if start_batch:
        log.info(f"{mode.capitalize()} Epoch: {epoch} resuming at batch "
                 f"{start_batch}/{n}")
    losses = []
    stage_walls = [0.0]  # wall of the most recent stage() call

    def stage(off, batch):
        if mode == "train":
            batch = faults.corrupt_batch_hook(batch, step_base + off + 1)
        t0 = time.perf_counter()
        with span("stage", mode=mode, step=step_base + off + 1):
            staged_batch = {"source_image": put_batch(batch["source_image"]),
                            "target_image": put_batch(batch["target_image"])}
        stage_walls[0] = time.perf_counter() - t0
        return staged_batch

    it = enumerate(loader)
    nxt = next(it, None)
    staged = stage(*nxt) if nxt is not None else None
    while nxt is not None:
        off, _ = nxt
        batch_idx = start_batch + off
        gstep = step_base + off + 1  # global step about to run (train mode)
        stage_wall, stage_walls[0] = stage_walls[0], 0.0
        images, staged = staged, None
        if tracer is not None and mode == "train":
            tracer.at_step(gstep)
        t_step = time.perf_counter()
        grad_norm = None
        # the per-step parent span: dispatch / stage(N+1) / loss_sync, and
        # any checkpoint commit inside on_step, nest under it
        with span(f"{mode}_step", step=gstep, batch=batch_idx):
            with annotate(f"{mode}_step"), \
                    span("dispatch", mode=mode, step=gstep):
                if mode == "train":
                    out = step_fn(state, images)
                    if len(out) == 3:
                        state, loss, grad_norm = out
                    else:
                        state, loss = out
                else:
                    loss = step_fn(state.params, images)
            # stage batch N+1 while step N runs on the card, then fetch
            # step N's loss (and grad norm) in one copy
            nxt = next(it, None)
            if nxt is not None:
                staged = stage(*nxt)
            with span("loss_sync", step=gstep):
                values = [loss] if grad_norm is None else [loss, grad_norm]
                fetched = torch.stack([v.detach().float()
                                       for v in values]).tolist()
            loss_f = fetched[0]
            losses.append(loss_f)
            if batch_idx % log_interval == 0:
                log.info(f"{mode.capitalize()} Epoch: {epoch} [{batch_idx}/{n} "
                         f"({100.0 * batch_idx / n:.0f}%)]\t\tLoss: "
                         f"{loss_f:.6f}")
            if mode == "train" and obs_events.get_global_sink() is not None:
                _emit_step(ctx, registry, images, epoch, batch_idx, gstep,
                           loss_f, fetched[1] if len(fetched) > 1 else None,
                           time.perf_counter() - t_step, stage_wall)
            stop_now = (on_step is not None
                        and on_step(batch_idx, state, loss_f))
        if stop_now:
            break
    if not losses:
        log.info(f"{mode.capitalize()} set: no batches past resume position "
                 f"{start_batch}/{n}")
        return state, float("nan")
    arr = np.asarray(losses, np.float32)
    if mode == "train":
        # guarded-away steps must not wipe out the epoch statistic; TRAIN
        # ONLY: a non-finite val loss keeps the epoch NaN (never best_)
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


def _emit_step(ctx, registry, images, epoch, batch_idx, gstep, loss_f,
               grad_norm, wall, stage_wall) -> None:
    """The ``step`` and ``quality`` events of one train step, and the
    registry's step metrics."""
    from ncnet_tpu_torch.observability.quality import active_tier, emit_quality

    pairs = int(images["source_image"].shape[0])
    fields: Dict[str, Any] = {
        "mode": "train", "epoch": epoch, "batch": batch_idx, "step": gstep,
        "loss": loss_f, "wall_s": round(wall, 6),
        "stage_wall_s": round(stage_wall, 6)}
    if pairs and wall > 0:
        fields["pairs_per_s"] = round(pairs / wall, 3)
    if grad_norm is not None:
        fields["grad_norm"] = grad_norm
    flops, peak = ctx.get("flops_per_pair"), ctx.get("peak_tflops")
    if flops and peak and pairs and wall > 0:
        fields["mfu_pct"] = round(
            100.0 * (flops * pairs / wall / 1e12) / peak, 2)
    obs_events.emit("step", **fields)
    # the weak loss is score(neg) − score(pos), so −loss is the pos/neg
    # score gap: a healthy run's grows
    if math.isfinite(loss_f):
        emit_quality("train", {"score_gap": [-loss_f]},
                     tier=active_tier(ctx.get("nc_bf16", False),
                                      stage="backward"),
                     registry=registry, step=gstep, epoch=epoch)
    if registry is not None:
        registry.timer("step_wall").observe(wall)
        registry.timer("stage_wall").observe(stage_wall)
        registry.gauge("loss").set(loss_f)
        for key in ("pairs_per_s", "mfu_pct", "grad_norm"):
            if key in fields:
                registry.gauge(key).set(fields[key])


# ---------------------------------------------------------------------------
# checkpointing (full train state)
# ---------------------------------------------------------------------------


def _reclaim_carcasses(root: str) -> None:
    """Drop ``.tmp`` carcasses of crashed saves (``fit`` is the root's sole
    writer); a ``.old`` (a same-step re-save's displaced original) is
    restored where :func:`~ncnet_tpu_torch.models.checkpoint.
    list_checkpoint_versions` counts it as its version, dropped
    otherwise."""
    recovered = {p for _, p in ckpt_io.list_checkpoint_versions(root)}
    for name in os.listdir(root):
        full = os.path.join(root, name)
        if name.endswith(".old") and full in recovered:
            os.rename(full, full[:-4])
        elif name.endswith((".tmp", ".old")):
            shutil.rmtree(full, ignore_errors=True)


def _finite_or_none(values) -> list:
    # non-finite entries (a resumed epoch whose train phase was already
    # consumed) serialize as null, keeping config.json strict JSON
    return [float(v) if math.isfinite(v) else None for v in values]


def save_train_checkpoint(path: str, config: TrainConfig,
                          model_config: ModelConfig, state: TrainState,
                          epoch: int, train_loss: np.ndarray,
                          test_loss: np.ndarray, is_best: bool, *,
                          step: Optional[int] = None,
                          position: Optional[Dict[str, int]] = None,
                          keep: int = 0, io_retries: int = 3,
                          io_retry_backoff: float = 0.5) -> str:
    """Atomic, versioned checkpoint of the full train state under the root
    ``path``: write ``step_<N>.tmp`` (``config.json``, then ``params/``,
    then ``opt/``), commit by rename, prune all but the newest ``keep``
    versions (``keep > 0``), and on improvement copy the version flat to
    ``best_<root name>`` beside the root (torch_util.py:48-61).  ``step``
    names the version (default ``state.step``); ``position`` is the resume
    cursor stored as ``_position``.  A crash at any point leaves every
    committed version intact.  Emits ``checkpoint_commit`` (with the
    save's wall and payload bytes).  Returns the committed directory.

    In a process group every rank calls it at the same step: rank 0 writes
    and commits, and all ranks leave together once rank 0 has broadcast
    the outcome, so no rank runs ahead of a save that may yet fail; a
    failed save raises on every rank."""
    root = os.path.abspath(path)
    n = int(state.step if step is None else step)
    final = os.path.join(root, ckpt_io.checkpoint_version_name(n))
    if pdist.rank() != 0:
        failure = pdist.broadcast_object(None)
        if failure is not None:
            raise RuntimeError(
                f"rank 0 failed to save checkpoint {final}: {failure}")
        return final
    try:
        committed = _write_train_checkpoint(
            root, final, n, config, model_config, state, epoch, train_loss,
            test_loss, is_best, position=position, keep=keep,
            io_retries=io_retries, io_retry_backoff=io_retry_backoff)
    except Exception as e:
        pdist.broadcast_object(f"{type(e).__name__}: {e}")
        raise
    pdist.broadcast_object(None)
    return committed


def _write_train_checkpoint(root, final, n, config, model_config, state,
                            epoch, train_loss, test_loss, is_best, *,
                            position, keep, io_retries, io_retry_backoff):
    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    tmp = final + ".tmp"
    _reclaim_carcasses(root)
    os.makedirs(tmp, exist_ok=True)
    params = ckpt_io.cpu_tree(state.params)
    ckpt_io.write_config_json(tmp, {
        **dataclasses.asdict(model_config),
        "_train": {k: v for k, v in dataclasses.asdict(config).items()
                   if k != "model"},
        "_epoch": epoch,
        "_step": n,
        "_position": position,
        "_train_loss": _finite_or_none(train_loss),
        "_test_loss": _finite_or_none(test_loss),
        # payload identity: resume refuses a bit-rotted or torn copy
        ckpt_io.PAYLOAD_SHA_KEY: ckpt_io.params_payload_sha256(params),
    })
    opt = {"opt_state": ckpt_io.cpu_tree(state.opt_state._asdict()),
           "step": n}

    def save(rel, tree):
        ckpt_io.with_io_retries(
            lambda: ckpt_io.save_tree(os.path.join(tmp, rel), tree),
            attempts=io_retries, backoff=io_retry_backoff,
            what=f"save of {tmp}/{os.path.dirname(rel)}")

    save(ckpt_io.PARAMS_FILE, params)
    faults.kill_mid_save_hook(n)  # no-op unless a test armed it
    save(OPT_FILE, opt)
    payload = sum(os.path.getsize(os.path.join(tmp, rel))
                  for rel in (ckpt_io.PARAMS_FILE, OPT_FILE))
    with annotate("checkpoint_commit"), span("checkpoint_commit", step=n):
        if os.path.isdir(final):
            # a re-save at the same step (an epoch-end save on a periodic
            # save's step): a complete directory stays at every instant
            stale = final + ".old"
            shutil.rmtree(stale, ignore_errors=True)
            os.rename(final, stale)
            os.rename(tmp, final)
            shutil.rmtree(stale, ignore_errors=True)
        else:
            os.rename(tmp, final)  # THE commit point
        if keep > 0:
            for _, old in ckpt_io.list_checkpoint_versions(root)[:-keep]:
                shutil.rmtree(old, ignore_errors=True)
        if is_best:
            best = os.path.join(os.path.dirname(root),
                                "best_" + os.path.basename(root))
            if os.path.isdir(best):
                shutil.rmtree(best)
            shutil.copytree(final, best)
    obs_events.emit("checkpoint_commit", step=n, path=final, epoch=epoch,
                    position=position, best=bool(is_best),
                    save_wall_s=round(time.perf_counter() - t0, 6),
                    bytes=payload)
    return final


def load_train_checkpoint(path: str, state_like: TrainState,
                          io_retries: int = 3, io_retry_backoff: float = 0.5):
    """Restore a full train state (params, Adam state, step) for resume,
    onto ``state_like``'s device.  ``path`` may be a root (its newest
    complete version), a version, or a flat checkpoint.  Returns
    ``(state, epoch, train_loss, test_loss, position)``: ``epoch`` counts
    completed epochs, ``position`` is the ``{"epoch", "next_batch"}``
    cursor.  A params payload that does not hash to the sha recorded at
    commit raises :class:`~ncnet_tpu_torch.models.checkpoint.
    CheckpointPayloadError`."""
    path = ckpt_io.resolve_checkpoint_dir(path)

    def load(rel):
        return ckpt_io.with_io_retries(
            lambda: ckpt_io.load_tree(path, rel), attempts=io_retries,
            backoff=io_retry_backoff,
            what=f"restore of {path}/{os.path.dirname(rel)}")

    params = load(ckpt_io.PARAMS_FILE)
    opt = load(OPT_FILE)
    ckpt_io.verify_checkpoint_payload(path, params)
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    dev = tree_leaves(state_like.params["nc"])[0].device
    state = TrainState(params_to(params, dev),
                       AdamState(**params_to(opt["opt_state"], dev)),
                       int(opt["step"]))
    position = meta.get("_position") or {
        "epoch": meta["_epoch"] + 1, "next_batch": 0}
    return (state, meta["_epoch"],
            # null entries (non-finite at save time) come back as NaN
            np.asarray([np.nan if v is None else v
                        for v in meta["_train_loss"]], dtype=np.float64),
            np.asarray([np.nan if v is None else v
                        for v in meta["_test_loss"]], dtype=np.float64),
            position)


class PreemptionHandler:
    """SIGTERM/SIGINT → "checkpoint at the next step boundary, then stop".

    Installed around the fit epoch loop.  The handler only flips a flag;
    the loop notices it between steps, writes a final checkpoint (with the
    exact resume position) and returns with ``result["preempted"]``.  A
    second SIGINT raises KeyboardInterrupt at once.  Installation is
    skipped off the main thread, and the previous handlers are restored."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.requested = False
        self.signum: Optional[int] = None
        self._old: Dict[int, Any] = {}

    def _handle(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self.requested = True
        self.signum = signum
        # os.write, not print: a buffered write interrupted by the signal
        # can replay its buffer, and print() can deadlock on its lock
        os.write(2, (f"[fault-tolerance] received "
                     f"{signal.Signals(signum).name}; will checkpoint at "
                     "the next step boundary and stop\n").encode())

    def __enter__(self) -> "PreemptionHandler":
        if threading.current_thread() is threading.main_thread():
            for s in self.SIGNALS:
                self._old[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old = {}
        return False


def _resolve_accum_chunks(config: TrainConfig, n_dev: int = 1) -> int:
    """The chunk count of a step: the auto default (-1) falls back to the
    whole-batch backward when fine-tuning the trunk, but an explicit count
    with fine-tuning is a contradiction the user must resolve.  Over
    ``n_dev`` data-parallel ranks a chunk of the global 2·batch volumes
    must divide over the ranks; each rank then walks the same number of
    chunks over its own volumes."""
    if config.fe_finetune_params > 0:
        if config.accum_chunks > 0:
            raise ValueError(
                f"accum_chunks={config.accum_chunks} requires the frozen "
                "trunk, but fe_finetune_params="
                f"{config.fe_finetune_params} finetunes backbone blocks; "
                "drop one of the two settings")
        return 0
    if config.accum_chunks == -1:
        return auto_accum_chunks(config.batch_size, n_dev)
    if config.accum_chunks < 0:
        raise ValueError(
            f"accum_chunks={config.accum_chunks}: use -1 (auto), 0 (off) or "
            "a positive chunk count")
    if config.accum_chunks and (2 * config.batch_size) % config.accum_chunks:
        raise ValueError(
            f"accum_chunks={config.accum_chunks} must divide "
            f"2*batch_size={2 * config.batch_size}")
    if config.accum_chunks and n_dev > 1:
        chunk = (2 * config.batch_size) // config.accum_chunks
        if chunk % n_dev:
            raise ValueError(
                f"accum_chunks={config.accum_chunks} gives chunk size "
                f"{chunk}, which does not divide over {n_dev} data-parallel "
                f"devices; pick a count where (2*batch_size/accum_chunks) % "
                f"n_devices == 0, or use -1 (auto)")
    return config.accum_chunks


def _feature_side(model_config: ModelConfig, params, image_size: int) -> int:
    """The trunk's output side at ``image_size``, traced on the meta
    device (no memory, no kernel)."""
    meta = params_to(params["backbone"], "meta")
    image = torch.empty((1, image_size, image_size, 3), device="meta")
    return int(extract_features(model_config, {"backbone": meta},
                                image).shape[1])


# ---------------------------------------------------------------------------
# fit: the whole reference train.py flow
# ---------------------------------------------------------------------------


def fit(config: TrainConfig, progress: bool = True,
        device=None) -> Dict[str, Any]:
    """Train per the reference recipe: epochs over ``train_pairs.csv``, the
    val loss on ``val_pairs.csv`` each epoch, a checkpoint every epoch (and
    every ``checkpoint_steps`` steps) and the best copy; resume, preemption
    and the NaN guard as the module docstring says.  Runs on CUDA unless
    ``device`` says otherwise.  Returns ``{state, model_config,
    train_loss, test_loss, best_test_loss, checkpoint, preempted,
    nan_steps_skipped, quarantined}``.

    Data parallelism (ROADMAP D7) runs one process per GPU: with
    ``distributed=True``, or with ``data_parallel`` under torchrun
    (``WORLD_SIZE`` > 1), ``fit`` joins the process group
    (``parallel/distributed.py``; each rank on the CUDA device of its
    ``LOCAL_RANK`` unless ``device`` says otherwise).  ``batch_size`` stays
    the global batch: each rank loads its shard of every epoch in local
    batches of ``batch_size / world`` and the step sums the ranks' parts
    of the loss and gradients (``make_train_step``).  Rank 0 alone writes
    the checkpoints and the telemetry; the others wait for each commit.
    The checkpoint root's name is rank 0's, the preemption stop is agreed
    at least every 8 steps (every ``checkpoint_steps`` when fewer), and
    I/O is not retried (a rank retrying alone would desynchronize the
    group)."""
    grouped = config.distributed or (config.data_parallel
                                     and pdist.env_world_size() > 1)
    if grouped:
        pdist.initialize_distributed(device=device)
        device = pdist.local_device(device)
    world = pdist.world_size()
    primary = pdist.rank() == 0
    data_parallel = grouped and config.data_parallel
    shard_kwargs = pdist.host_shard() if grouped else {}
    local_batch = config.batch_size
    if grouped and world > 1:
        if not config.data_parallel:
            # each rank would silently train its own diverging model
            raise ValueError(
                "distributed=True across multiple processes requires "
                "data_parallel=True (there is no gradient sync otherwise)")
        if config.batch_size % world:
            raise ValueError(f"batch_size {config.batch_size} must divide "
                             f"evenly over {world} processes")
        if not config.val_drop_last:
            # a partial trailing val batch would change the global batch
            # the negatives roll over
            raise ValueError(
                "val_drop_last=False is incompatible with data_parallel "
                "across multiple devices; disable one of the two")
        local_batch = config.batch_size // world
    if grouped and progress:
        log.info(f"Distributed: process {pdist.rank()} of {world}")
    state, optimizer, model_config, labels = create_train_state(
        config, device=device)
    dev = tree_leaves(state.params["nc"])[0].device

    # resume: a checkpoint written by fit() carries opt/: restore the full
    # train state; a root resolves to its newest COMPLETE version
    start_epoch = 0
    prev_train = prev_test = None
    resume_epoch: Optional[int] = None
    resume_batch = 0
    resume_root = None
    ckpt = config.model.checkpoint
    resolved = (ckpt_io.resolve_checkpoint_dir(ckpt)
                if ckpt and os.path.isdir(ckpt) else "")
    if resolved and os.path.isdir(os.path.join(resolved, "opt")):
        state, start_epoch, prev_train, prev_test, position = (
            load_train_checkpoint(resolved, state,
                                  io_retries=config.io_retries,
                                  io_retry_backoff=config.io_retry_backoff))
        resume_epoch = int(position["epoch"])
        resume_batch = int(position["next_batch"])
        # resumed from our own versioned output: keep writing new versions
        # into the SAME root
        resume_root = ckpt_io.owning_checkpoint_root(resolved)
        if progress:
            log.info(f"Resumed full train state from {resolved}: "
                     f"{start_epoch} completed epoch(s), position epoch "
                     f"{resume_epoch} batch {resume_batch}")

    n_trainable = sum(
        x.numel() for x, lbl in zip(tree_leaves(state.params),
                                    tree_leaves(labels))
        if lbl == "trainable")
    if progress:
        log.info(f"Trainable parameters: {n_trainable:,}")

    accum = _resolve_accum_chunks(config, world if data_parallel else 1)
    if progress and accum:
        log.info(f"Gradient accumulation: {accum} chunks of "
                 f"{2 * config.batch_size // accum} volumes")
    train_step = make_train_step(
        model_config, optimizer, donate=config.donate_state,
        stop_backbone_grad=config.fe_finetune_params == 0,
        remat_nc_layers=config.remat_nc_layers,
        nc_custom_grad=config.nc_custom_grad,
        fold_pos_neg=config.fold_pos_neg, remat_filter=config.remat_filter,
        accum_chunks=accum, nan_guard=config.nan_guard,
        nc_pallas_vjp=config.nc_pallas_vjp,
        # the same step on every rank: the grad norm is computed everywhere
        # and read by the primary's telemetry only
        with_grad_norm=config.telemetry, data_parallel=data_parallel)
    eval_step = make_eval_step(model_config, data_parallel=data_parallel)

    decode_policy = "quarantine" if config.quarantine_decode_errors else "raise"
    size = (config.image_size, config.image_size)

    def pairs(csv_file):
        return ImagePairDataset(
            config.dataset_csv_path, csv_file, config.dataset_image_path,
            output_size=size, seed=config.seed,
            decode_retries=config.decode_retries)

    train_loader = DataLoader(
        pairs("train_pairs.csv"), batch_size=local_batch, shuffle=True,
        num_workers=config.num_workers, seed=config.seed, drop_last=True,
        on_decode_error=decode_policy, **shard_kwargs)
    # val: no shuffle — with drop_last a shuffle would drop a different
    # random subset each epoch, making the best-checkpoint metric noisy
    val_loader = DataLoader(
        pairs("val_pairs.csv"), batch_size=local_batch, shuffle=False,
        num_workers=config.eval_num_workers, seed=config.seed,
        drop_last=config.val_drop_last, on_decode_error=decode_policy,
        **shard_kwargs)

    # gmtime, not localtime: the name must not depend on the TZ setting;
    # every rank takes rank 0's
    ckpt_name = resume_root or pdist.broadcast_object(os.path.join(
        config.result_model_dir,
        time.strftime("%Y-%m-%d_%H:%M", time.gmtime(time.time()))
        + "_" + config.result_model_fn))
    if progress:
        log.info(f"Checkpoint name: {ckpt_name}")

    # telemetry: event log + heartbeat + device monitor; the log lives under
    # the root by default, so a lineage's crash/resume cycles append to ONE
    # file, each run under its own run id
    telemetry: Optional[EventLog] = None
    prev_sink = None
    heartbeat: Optional[Heartbeat] = None
    dev_monitor: Optional[DeviceMonitor] = None
    train_registry: Optional[MetricsRegistry] = None
    # rank 0 alone traces: every rank would write the same file
    step_tracer = StepWindowTracer(config.profile_dir if primary else None)
    # the tracer rides along even without an event log
    telemetry_ctx: Dict[str, Any] = {"tracer": step_tracer}
    if config.telemetry and primary:
        tdir = config.telemetry_dir or os.path.join(ckpt_name, "telemetry")
        try:
            telemetry = EventLog(os.path.join(tdir, "events.jsonl"),
                                 run_meta={"config": dataclasses.asdict(config)})
        except OSError as e:
            # telemetry must never be the reason a run cannot start
            log.warning(f"could not open the event log under {tdir} ({e}); "
                        "continuing without telemetry", kind="io")
    if telemetry is not None:
        prev_sink = obs_events.set_global_sink(telemetry)
        heartbeat = Heartbeat(os.path.join(
            os.path.dirname(telemetry.path), "heartbeat.json"),
            run_id=telemetry.run_id)
        dev_monitor = DeviceMonitor()
        train_registry = MetricsRegistry(scope="train_step")
        telemetry_ctx.update(
            registry=train_registry, peak_tflops=device_peak_tflops(),
            # the step can take a kernel tier only when the NC stack runs
            # bf16 with the kernel VJP permitted
            nc_bf16=bool(model_config.half_precision and config.nc_pallas_vjp),
            flops_per_pair=train_step_flops(
                _feature_side(model_config, state.params, config.image_size),
                model_config.ncons_kernel_sizes,
                model_config.ncons_channels))
        obs_events.emit(
            "run_start", envelope=obs_events.run_envelope(telemetry.run_id),
            checkpoint_root=ckpt_name, num_epochs=config.num_epochs,
            batch_size=config.batch_size, resumed=bool(resume_root))
        if resume_root:
            obs_events.emit("resume", checkpoint=resolved,
                            completed_epochs=start_epoch, epoch=resume_epoch,
                            batch=resume_batch, step=int(state.step))

    train_loss = np.zeros(config.num_epochs)
    test_loss = np.zeros(config.num_epochs)
    best = float("inf")
    if prev_train is not None and start_epoch > 0:
        n_keep = min(start_epoch, config.num_epochs)
        train_loss[:n_keep] = prev_train[:n_keep]
        test_loss[:n_keep] = prev_test[:n_keep]
        finite_prev = prev_test[:n_keep][np.isfinite(prev_test[:n_keep])]
        if finite_prev.size:
            best = float(np.min(finite_prev))

    if len(train_loader) == 0:
        raise ValueError(
            "train loader is empty (dataset smaller than batch_size with "
            "drop_last) — refusing to report a fake 0.0 epoch loss")

    first_epoch = resume_epoch if resume_epoch is not None else start_epoch + 1
    steps_done = int(state.step)
    if resume_root and primary:
        # explicit rollback (resume from a non-newest version): newer
        # versions are stale; left in place, a crash before the new lineage
        # passes them would make the next resume pick the very checkpoint
        # the operator rolled back from
        for n_v, p_v in ckpt_io.list_checkpoint_versions(resume_root):
            if n_v > steps_done:
                shutil.rmtree(p_v, ignore_errors=True)
                log.warning(f"[fault-tolerance] pruned stale version {p_v} "
                            f"(rolled back to step {steps_done})",
                            kind="validation")
    if resume_root:
        pdist.barrier()
    nan_streak = nan_skipped = 0
    preempted = False
    save_kwargs = dict(keep=config.keep_checkpoints,
                       io_retries=config.io_retries,
                       io_retry_backoff=config.io_retry_backoff)

    @contextlib.contextmanager
    def _telemetry_scope():
        """run_end, the perf store's summary, sink restore and log close on
        every exit path (completion, preemption, divergence, a crash)."""
        try:
            yield
        finally:
            step_tracer.close()
            if telemetry is not None:
                _record_run_summary(train_registry, telemetry.run_id)
                obs_events.emit("run_end", step=steps_done,
                                preempted=preempted,
                                nan_steps_skipped=nan_skipped)
                obs_events.set_global_sink(prev_sink)
                try:
                    telemetry.close()
                except OSError:  # best-effort: the log is already fsynced
                    pass

    with _telemetry_scope(), PreemptionHandler() as preempt:
        for epoch in range(first_epoch, config.num_epochs + 1):
            start_b = resume_batch if epoch == first_epoch else 0
            n_train = len(train_loader)
            train_loader.set_epoch(epoch, start_batch=min(start_b, n_train))
            val_loader.set_epoch(epoch)
            stop_epoch = {"preempted": False}

            def on_step(batch_idx, cur_state, loss, epoch=epoch,
                        stop=stop_epoch):
                nonlocal steps_done, nan_streak, nan_skipped
                steps_done += 1
                if heartbeat is not None:
                    heartbeat.beat(step=steps_done)
                if dev_monitor is not None:
                    dev_monitor.maybe_emit(step=steps_done)
                if config.nan_guard:
                    if not math.isfinite(loss):
                        nan_streak += 1
                        nan_skipped += 1
                        log.warning(f"[fault-tolerance] non-finite loss at "
                                    f"step {steps_done}: update skipped "
                                    f"(streak {nan_streak}/"
                                    f"{config.max_bad_steps})",
                                    kind="nan_guard")
                        obs_events.emit("nan_skip", step=steps_done,
                                        epoch=epoch, streak=nan_streak)
                        if train_registry is not None:
                            train_registry.counter("nan_skips").inc()
                        if nan_streak >= config.max_bad_steps:
                            obs_events.emit("diverged", step=steps_done,
                                            epoch=epoch, streak=nan_streak)
                            raise TrainDivergedError(
                                f"{nan_streak} consecutive non-finite losses "
                                f"up to step {steps_done} (epoch {epoch}); "
                                "params/opt state are NOT corrupted (every "
                                "bad update was skipped) — lower the lr or "
                                "inspect the data")
                    else:
                        nan_streak = 0
                faults.sigterm_hook(steps_done)  # no-op unless a test armed it
                at_ckpt = (config.checkpoint_steps > 0
                           and steps_done % config.checkpoint_steps == 0)
                if world > 1:
                    # no rank may stop (and final-save) alone: the ranks
                    # agree, at least every 8 steps so a preemption's grace
                    # window is kept whatever checkpoint_steps is
                    agree_every = (min(config.checkpoint_steps, 8)
                                   if config.checkpoint_steps else 8)
                    want_stop = (steps_done % agree_every == 0
                                 and pdist.global_any(preempt.requested, dev))
                else:
                    want_stop = preempt.requested
                if want_stop or at_ckpt:
                    save_train_checkpoint(
                        ckpt_name, config, model_config, cur_state,
                        epoch - 1, train_loss, test_loss, False,
                        step=steps_done,
                        position={"epoch": epoch, "next_batch": batch_idx + 1},
                        **save_kwargs)
                    if train_registry is not None:
                        train_registry.counter("checkpoint_commits").inc()
                if want_stop:
                    obs_events.emit("preemption", step=steps_done,
                                    epoch=epoch, batch=batch_idx)
                    stop["preempted"] = True
                    return True
                return False

            obs_events.emit("epoch_start", epoch=epoch,
                            start_batch=min(start_b, n_train),
                            n_batches=n_train)
            if train_loader.start_batch < n_train:
                # trace only the first epoch after a (re)start, unless a
                # step-window tracer owns the one profiler session
                with maybe_trace(config.profile_dir,
                                 enabled=(epoch == first_epoch
                                          and not step_tracer.enabled)):
                    state, train_loss[epoch - 1] = process_epoch(
                        "train", epoch, state, train_step, train_loader,
                        config.log_interval, step_base=steps_done,
                        on_step=on_step, telemetry_ctx=telemetry_ctx)
            else:
                # resume position at the epoch's very end (killed between
                # the last periodic save and the epoch-end save): val and
                # the epoch-end save still run
                log.info(f"Train Epoch: {epoch} already fully consumed at "
                         "the resume position; skipping to validation")
                train_loss[epoch - 1] = float("nan")
            if stop_epoch["preempted"]:
                preempted = True
                break
            _, test_loss[epoch - 1] = process_epoch(
                "test", epoch, state, eval_step, val_loader,
                config.log_interval)
            is_best = test_loss[epoch - 1] < best  # False for a NaN epoch
            # fmin: a NaN val epoch must not poison best tracking
            best = float(np.fmin(test_loss[epoch - 1], best))
            save_train_checkpoint(
                ckpt_name, config, model_config, state, epoch, train_loss,
                test_loss, is_best, step=steps_done,
                position={"epoch": epoch + 1, "next_batch": 0},
                **save_kwargs)
            if train_registry is not None:
                train_registry.counter("checkpoint_commits").inc()
            obs_events.emit("epoch_end", epoch=epoch, step=steps_done,
                            train_loss=float(train_loss[epoch - 1]),
                            test_loss=float(test_loss[epoch - 1]),
                            best=bool(is_best))
            if train_registry is not None:
                train_registry.flush(epoch=epoch)
            if pdist.global_any(preempt.requested, dev):
                preempted = True
                log.info("[fault-tolerance] stopping after the epoch "
                         "checkpoint (preemption requested)",
                         kind="preemption")
                obs_events.emit("preemption", step=steps_done, epoch=epoch,
                                boundary="epoch")
                break
    if preempted and progress:
        log.info(f"Preemption checkpoint committed under {ckpt_name}; "
                 "resume by pointing --checkpoint at it", kind="preemption")
    return {
        "state": state,
        "model_config": model_config,
        "train_loss": train_loss,
        "test_loss": test_loss,
        "best_test_loss": best,
        "checkpoint": ckpt_name,
        "preempted": preempted,
        "nan_steps_skipped": nan_skipped,
        "quarantined": sorted(train_loader.quarantined
                              | val_loader.quarantined),
    }


def _record_run_summary(registry: Optional[MetricsRegistry],
                        run_id: str) -> None:
    """The run's final metrics flush, and its step-wall and throughput
    summary into the perf store (fail-open), as the JAX ``fit`` records
    them: medians of the walls (the first step's warm-up would dominate a
    short run's mean), the last throughput and MFU, and the mean score
    gap."""
    if registry is None:
        return
    from ncnet_tpu_torch.observability import perfstore

    registry.flush(final=True)
    snap = registry.snapshot()
    summary: Dict[str, float] = {}
    for name, key in (("step_wall", "train_step_wall_s"),
                      ("stage_wall", "train_stage_wall_s")):
        st = snap.get(name)
        if isinstance(st, dict) and st.get("count"):
            summary[key] = st.get("p50_s", st["mean_s"])
    for name, key in (("pairs_per_s", "train_pairs_per_s"),
                      ("mfu_pct", "train_mfu_pct")):
        v = snap.get(name)
        if isinstance(v, (int, float)):
            summary[key] = float(v)
    gap = snap.get("q_score_gap")
    if isinstance(gap, dict) and gap.get("count") \
            and isinstance(gap.get("mean"), (int, float)):
        summary["train_quality_score_gap"] = gap["mean"]
    perfstore.maybe_record(summary, source="fit", run_id=run_id)
