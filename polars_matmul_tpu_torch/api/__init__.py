from .search import Corpus, matmul, topk  # noqa: F401
