"""Configuration of the PyTorch port.

``ModelConfig``, ``TrainConfig``, ``EvalPFPascalConfig``,
``EvalInLocConfig`` and ``LocalizationConfig`` repeat
``ncnet_tpu/config.py`` field for field (same names, same defaults), so a configuration written for the JAX package
means the same model and run here.  Options the port does not run yet are
still fields; the code rejects them loudly (``models/ncnet.py::
check_ported``, ``evaluation/inloc.py::check_inloc_ported``).  The other config
dataclasses come with the slices that use them.
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
    """Weak-supervision training run (reference train.py:34-47 flags), read
    by ``training/train.py::fit`` and ``cli/train.py``.  ``batch_size`` is
    the global batch; ``distributed`` and ``data_parallel`` select the
    data-parallel run over ``torch.distributed`` (ROADMAP D7);
    ``donate_state`` has no counterpart in eager PyTorch."""

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
    fe_finetune_params: int = 0          # >0: fine-tune the last trunk blocks
    finetune_cp_rank: int = 0            # >0: fine-tune rank-R CP factors
    seed: int = 1
    num_workers: int = 0
    eval_num_workers: int = 4
    log_interval: int = 1
    data_parallel: bool = True           # under torchrun (WORLD_SIZE > 1): one
                                         # rank a GPU, gradients all-reduced
    donate_state: bool = True            # no counterpart in eager PyTorch
    remat_nc_layers: bool = False        # recompute each NC layer in the backward
    nc_custom_grad: bool = False         # the conv4d_same custom backward
    fold_pos_neg: bool = False           # one 2B-volume filter call (accum_chunks=0)
    nc_pallas_vjp: bool = True           # the B3 backward where compiled
    remat_filter: bool = True            # recompute the filter in the backward
    accum_chunks: int = -1               # -1 auto, 0 whole batch, >1 chunks
    val_drop_last: bool = True
    distributed: bool = False            # join the torch.distributed group
                                         # (torchrun's env), even at world 1
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


@dataclasses.dataclass(frozen=True)
class EvalPFPascalConfig:
    """PCK evaluation on PF-Pascal (reference eval_pf_pascal.py:28-30)."""

    checkpoint: str = ""
    image_size: int = 400
    eval_dataset_path: str = "datasets/pf-pascal/"
    pck_alpha: float = 0.1
    pck_procedure: str = "scnet"
    # coarse-to-fine matching (ModelConfig.sparse_topk) when the eval builds
    # the net itself; a caller-supplied net keeps its own. 0 = dense
    sparse_topk: int = 0
    # fault tolerance (evaluation/resilience.py):
    journal_dir: str = ""                # journal per-batch rows + the run
                                         # manifest here; a rerun with the
                                         # same settings resumes to a
                                         # bit-equal result. "" = none
    query_retries: int = 2               # per-batch retries after the first
                                         # dispatch/fetch failure
    retry_backoff_s: float = 0.5         # seconds, doubled per attempt
    quarantine: bool = True              # exhausted retries: record the batch
                                         # in the manifest, score its pairs
                                         # NaN and go on (else raise)
    fetch_timeout_s: float = 0.0         # watchdog around each fetch; 0 = off
    decode_retries: int = 1              # per-image transient decode retries
    # observability: open an event log here for the run. "" = emit only to
    # an already-bound global sink, if any
    telemetry_dir: str = ""


@dataclasses.dataclass(frozen=True)
class EvalInLocConfig:
    """Dense matching for InLoc localization (reference eval_inloc.py:30-40),
    read by ``evaluation/inloc.py::run_inloc_eval`` and
    ``cli/eval_inloc.py``.  ``feature_store_dir`` and ``retrieval_index``
    (ROADMAP A12) are refused."""

    checkpoint: str = ""
    inloc_shortlist: str = "datasets/inloc/densePE_top100_shortlist_cvpr18.mat"
    k_size: int = 2
    image_size: int = 3200
    n_queries: int = 356
    n_panos: int = 10
    softmax: bool = True
    matching_both_directions: bool = True
    flip_matching_direction: bool = False
    pano_path: str = "datasets/inloc/pano/"
    query_path: str = "datasets/inloc/query/iphone7/"
    output_root: str = "matches"
    spatial_shards: int = 1              # > 1: the volume's hB split over this
                                         # many local devices
    # coarse-to-fine matching (ModelConfig.sparse_topk); needs k_size=1
    # (relocalization keeps the dense path). 0 = dense
    sparse_topk: int = 0
    # dispatch/fetch depth: 0 = adaptive (2 to 4), > 0 pins it
    pipeline_depth: int = 0
    # stripe queries across hosts (one .mat per query; each host its own
    # manifest). -1 / 0: from torch.distributed when initialised, else
    # the one stripe
    host_index: int = -1
    host_count: int = 0
    skip_existing: bool = True           # resume by artifact
    # fault tolerance (evaluation/resilience.py):
    validate_existing: bool = True       # loadmat-validate an artifact
                                         # before skipping it
    query_retries: int = 2               # per-query retries after the first
                                         # failure
    retry_backoff_s: float = 0.5         # seconds, doubled per attempt
    quarantine: bool = True              # exhausted retries: record the
                                         # query in the manifest and go on
    fetch_timeout_s: float = 0.0         # watchdog around each pair fetch;
                                         # 0 = off
    write_manifest: bool = True          # journal completed / quarantined /
                                         # in-flight queries
    # observability: open an event log here for the run. "" = emit only to
    # an already-bound global sink, if any
    telemetry_dir: str = ""
    feature_store_dir: str = ""          # refused: the feature store (A12)
    feature_store_budget_mb: int = 0
    retrieval_index: str = ""            # refused: the retrieval shortlist (A12)
    retrieval_topk: int = 0
    retrieval_min_coverage: float = 1.0


@dataclasses.dataclass(frozen=True)
class LocalizationConfig:
    """InLoc downstream localization (the reference's MATLAB L6 stage,
    compute_densePE_NCNet.m: thresholds at :33-34, pnp_topN at :31), read
    by ``localization/driver.py::run_localization`` and
    ``cli/compute_localization.py``."""

    matches_dir: str = ""                # matches/<experiment> from eval_inloc
    shortlist: str = "datasets/inloc/densePE_top100_shortlist_cvpr18.mat"
    query_path: str = "datasets/inloc/query/iphone7/"
    cutout_path: str = "datasets/inloc/pano/"     # cutout images + XYZcut .mat
    cutout_mat_suffix: str = ".mat"      # appended to the cutout name
    scan_path: str = "datasets/inloc/scans/"      # *_scan_*.ptx.mat
    scan_suffix: str = ".ptx.mat"
    transformation_path: str = "datasets/inloc/"  # <floor>/transformations/
    refposes: str = "datasets/inloc/DUC_refposes_all.mat"
    output_dir: str = "outputs_localization"
    pnp_topN: int = 10                   # candidates per query
    match_score_thr: float = 0.75        # params.ncnet.thr
    pnp_inlier_thr_deg: float = 0.2      # params.ncnet.pnp_thr (degrees)
    ransac_iters: int = 10000
    max_tentatives: int = 0              # params.ncnet.N_subsample; 0 = all
    do_pose_verification: bool = True    # the densePV rerank stage
    query_focal_length: float = 0.0      # pixels; 0 → iPhone 7 EXIF default
    n_queries: int = 0                   # 0 = all queries in the shortlist
    seed: int = 0
    progress: bool = True
    num_workers: int = 0                 # >0: PnP (per query) and pose
                                         # verification (per scan) fan out
                                         # over spawn process pools — the
                                         # reference's two parfor loops
    # fault tolerance (evaluation/resilience.py): per-query isolation of the
    # PnP stage — a query whose matches/.mat/cutout data is broken is
    # retried, then quarantined into the stage manifest (it scores as
    # not-localized downstream), instead of aborting the stage
    query_retries: int = 2
    retry_backoff_s: float = 0.5
    quarantine: bool = True
