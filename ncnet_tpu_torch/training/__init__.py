"""Training: the weak-supervision loss, the Adam step, the epoch loop,
versioned checkpoints and ``fit``."""

from ncnet_tpu_torch.training.loss import (
    auto_accum_chunks,
    match_score,
    match_score_per_pair,
    weak_loss,
    weak_loss_and_grads,
)
from ncnet_tpu_torch.training.train import (
    Adam,
    PreemptionHandler,
    TrainDivergedError,
    TrainState,
    check_train_ported,
    create_train_state,
    fit,
    load_train_checkpoint,
    make_eval_step,
    make_optimizer,
    make_train_step,
    process_epoch,
    save_train_checkpoint,
    trainable_labels,
)

__all__ = [
    "Adam",
    "PreemptionHandler",
    "TrainDivergedError",
    "TrainState",
    "auto_accum_chunks",
    "check_train_ported",
    "create_train_state",
    "fit",
    "load_train_checkpoint",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "match_score",
    "match_score_per_pair",
    "process_epoch",
    "save_train_checkpoint",
    "trainable_labels",
    "weak_loss",
    "weak_loss_and_grads",
]
