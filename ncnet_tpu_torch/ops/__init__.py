"""Tensor ops of the port (one module per JAX ``ncnet_tpu/ops`` module).

The coarse-to-fine and tracking names are re-exported here as the JAX
package's ``ops/__init__.py`` re-exports them.  No re-exported name is a
submodule's name, so ``ncnet_tpu_torch.ops.<submodule>`` always means the
module; import the other ops from their submodules.
"""

from ncnet_tpu_torch.ops.matching import scatter_sparse_scores  # noqa: F401
from ncnet_tpu_torch.ops.sparse_corr import (  # noqa: F401
    choose_match_pipeline,
    choose_tracked_pipeline,
    coarse2fine_feasible,
    sparse_fine_corr,
    sparse_mutual_matching,
    sparse_refine,
    tracking_feasible,
)
from ncnet_tpu_torch.ops.sparse_topk import (  # noqa: F401
    candidate_recall,
    pool_features,
    topk_candidates,
)
from ncnet_tpu_torch.ops.temporal import (  # noqa: F401
    FEATURE_STRIDE,
    identity_prior,
    prior_from_table,
    temporal_candidates,
    tracking_recall_proxy,
    window_size,
)
