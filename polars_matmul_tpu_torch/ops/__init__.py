from .metrics import Metric, cosine_eps  # noqa: F401
from .reference import pairwise_scores, topk_from_scores, topk_search  # noqa: F401
