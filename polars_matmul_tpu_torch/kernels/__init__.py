# The module ``fused_topk`` is not shadowed by its function of the same
# name: ``polars_matmul_tpu_torch.topk_torch`` is that function.
from .fused_topk import (fused_topk_prepared, launches,  # noqa: F401
                         prepare_corpus, reset_launch_counts)
from .matmul import pairwise_matmul, pallas_matmul  # noqa: F401
