"""Training: the weak-supervision loss, the Adam step, the epoch loop."""

from ncnet_tpu_torch.training.loss import (
    auto_accum_chunks,
    match_score,
    match_score_per_pair,
    weak_loss,
    weak_loss_and_grads,
)
from ncnet_tpu_torch.training.train import (
    Adam,
    TrainState,
    check_train_ported,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    process_epoch,
    trainable_labels,
)

__all__ = [
    "Adam",
    "TrainState",
    "auto_accum_chunks",
    "check_train_ported",
    "create_train_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "match_score",
    "match_score_per_pair",
    "process_epoch",
    "trainable_labels",
    "weak_loss",
    "weak_loss_and_grads",
]
