"""Configuration of the PyTorch port.

``ModelConfig`` and ``TrainConfig`` repeat ``ncnet_tpu/config.py`` field for
field (same names, same defaults), so a configuration written for the JAX
package means the same model and run here.  Options the port does not run
yet are still fields; the code rejects them loudly (``models/ncnet.py::
check_ported``, ``training/train.py::check_train_ported``).  The other
config dataclasses come with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the NCNet model (reference ImMatchNet defaults)."""

    backbone: str = "resnet101"          # 'resnet101' | 'vgg' | 'densenet201' | 'tiny'
    backbone_last_layer: str = ""        # '' → layer3 (resnet) / pool4 (vgg)
    ncons_kernel_sizes: Sequence[int] = (3, 3, 3)
    ncons_channels: Sequence[int] = (10, 10, 1)
    symmetric_mode: bool = True
    normalize_features: bool = True
    relocalization_k_size: int = 0       # >1 enables maxpool4d relocalization
    sparse_topk: int = 0                 # >0: coarse-to-fine sparse matching
    sparse_factor: int = 2               # coarse pooling factor
    sparse_halo: int = -1                # fine-cell halo; -1 = one coarse ring
    track_radius: int = 0                # streaming tracked-mode search radius
    nc_tier: str = ""                    # force an arithmetic NC tier ('cp' | 'fft')
    half_precision: bool = False         # bf16 volume + NC weights
    backbone_bf16: bool = False          # run the frozen trunk in bf16
    backbone_weights: str = ""           # torchvision state_dict for the trunk
    checkpoint: str = ""                 # path to a saved model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Weak-supervision training run (reference train.py:34-47 flags).

    The fields the port's training step reads are ``model``, ``lr``,
    ``seed``, ``batch_size``, ``accum_chunks``, ``nan_guard`` and the
    unported options below; the rest belong to ``fit``, the data loader and
    the CLI, which come in a later slice."""

    model: ModelConfig = ModelConfig(
        ncons_kernel_sizes=(5, 5, 5), ncons_channels=(16, 16, 1))
    image_size: int = 400
    dataset_image_path: str = "datasets/pf-pascal/"
    dataset_csv_path: str = "datasets/pf-pascal/image_pairs/"
    num_epochs: int = 5
    batch_size: int = 16
    lr: float = 5e-4
    result_model_fn: str = "checkpoint_adam"
    result_model_dir: str = "trained_models"
    fe_finetune_params: int = 0          # >0 not ported: trunk fine-tuning
    finetune_cp_rank: int = 0            # >0 not ported: the CP fine-tune
    seed: int = 1
    num_workers: int = 0
    eval_num_workers: int = 4
    log_interval: int = 1
    data_parallel: bool = True           # shard the pair batch over devices
    donate_state: bool = True            # no counterpart in eager PyTorch
    remat_nc_layers: bool = False        # True refused by the recipe (the steps take it)
    nc_custom_grad: bool = False         # True refused by the recipe (the steps take it)
    fold_pos_neg: bool = False           # one 2B-volume filter call (accum_chunks=0)
    nc_pallas_vjp: bool = True           # False refused by the recipe (the steps take it)
    remat_filter: bool = True            # recompute the filter in the backward
    accum_chunks: int = -1               # -1 auto, 0 whole batch, >1 chunks
    val_drop_last: bool = True
    distributed: bool = False            # True not ported: multi-host runs
    profile_dir: str = ""
    telemetry: bool = True
    telemetry_dir: str = ""
    checkpoint_steps: int = 0
    keep_checkpoints: int = 3
    nan_guard: bool = True               # skip a non-finite update
    max_bad_steps: int = 3
    io_retries: int = 3
    io_retry_backoff: float = 0.5
    decode_retries: int = 1
    quarantine_decode_errors: bool = True
