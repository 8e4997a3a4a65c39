"""Model assembly: backbones, NCNet composition, parameter conversion."""

from ncnet_tpu_torch.models.backbone import backbone_apply, backbone_init
from ncnet_tpu_torch.models.convert import params_from_numpy
from ncnet_tpu_torch.models.ncnet import (
    NCNet,
    NCNetOutput,
    coarse2fine_filter,
    coarse2fine_tracked_filter,
    extract_features,
    init_ncnet,
    make_point_matcher,
    ncnet_filter,
    ncnet_forward,
    ncnet_forward_from_feature_pair,
    ncnet_forward_from_features,
    ncnet_forward_tracked,
    ncnet_match_volume,
    neigh_consensus,
)

__all__ = [
    "NCNet",
    "NCNetOutput",
    "backbone_apply",
    "backbone_init",
    "coarse2fine_filter",
    "coarse2fine_tracked_filter",
    "extract_features",
    "init_ncnet",
    "make_point_matcher",
    "ncnet_filter",
    "ncnet_forward",
    "ncnet_forward_from_feature_pair",
    "ncnet_forward_from_features",
    "ncnet_forward_tracked",
    "ncnet_match_volume",
    "neigh_consensus",
    "params_from_numpy",
]
