"""Quickstart: the README walkthrough as a runnable script.

The port of the JAX package's ``examples/quickstart.py``.  Uses the Polars
``.pmm`` namespace when polars imports, else the Arrow surface when
pyarrow imports, else the raw Arrow buffers that surface stands on
(``api.arrow_ops.topk_buffers``, no pyarrow needed); then the NumPy
surface.  It prints which surface it used.  Runs on the card, or on the
CPU with ``--cpu``:

    python -m polars_matmul_tpu_torch.examples.quickstart [--cpu]
"""

from __future__ import annotations

import numpy as np

import polars_matmul_tpu_torch as pmt
from polars_matmul_tpu_torch.api.arrow_ops import topk_buffers
from polars_matmul_tpu_torch.interop import buffers as B

from ._common import check, parser, pick_device

QUERIES = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
CORPUS = [[0.9, 0.1, 0.0], [0.1, 0.9, 0.0], [0.0, 0.1, 0.9]]


def with_polars(device):
    import polars as pl

    queries = pl.DataFrame({"id": [0, 1, 2], "embedding": QUERIES})
    corpus = pl.DataFrame({"embedding": CORPUS, "label": ["a", "b", "c"]})
    out = queries.with_columns(
        pl.col("embedding").pmm.topk(corpus["embedding"], k=2,
                                     device=device).alias("matches"))
    print(out)
    return out["matches"].to_list()


def _print_rows(rows):
    for row_id, row in enumerate(rows):
        print(f"query {row_id}: {row}")
    return rows


def with_arrow(device):
    import pyarrow as pa

    matches = pmt.topk_arrow(pa.array(QUERIES), pa.array(CORPUS), k=2,
                             device=device)
    return _print_rows(matches.to_pylist())


def list_column(rows) -> B.EmbeddingColumn:
    """The List<double> column ``pa.array(rows)`` makes, by its buffers."""
    values = np.asarray(rows, dtype=np.float64)
    dim = values.shape[1]
    return B.EmbeddingColumn(
        length=len(rows), values=values.reshape(-1),
        offsets=np.arange(0, dim * len(rows) + 1, dim, dtype=np.int32))


def with_buffers(device):
    out = topk_buffers(list_column(QUERIES), list_column(CORPUS), k=2,
                       device=device)
    rows = [[{"index": int(out.index[j]), "score": float(out.score[j])}
             for j in range(out.offsets[i], out.offsets[i + 1])]
            for i in range(len(out))]
    return _print_rows(rows)


def with_numpy(device):
    q = np.asarray(QUERIES, dtype=np.float32)
    c = np.asarray(CORPUS, dtype=np.float32)

    idx, scores = pmt.topk(q, c, k=2, device=device)     # one-shot
    print("one-shot indices:\n", idx)

    handle = pmt.Corpus(c, device=device)                 # resident corpus
    idx2, scores2 = handle.topk(q, k=2)
    check(np.array_equal(idx, idx2), "Corpus.topk differs from topk")
    print("scores:\n", np.round(scores, 4))
    return idx, scores


SURFACES = ("polars", "pyarrow", "buffers")


def surface(first: str = "polars") -> str:
    """The first surface from ``first`` on that imports: polars, pyarrow,
    else buffers."""
    for name in SURFACES[SURFACES.index(first):-1]:
        try:
            __import__(name)
        except ImportError:
            continue
        return name
    return "buffers"


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--surface", choices=SURFACES, default="polars",
                    help="the first surface to try (default: polars, then "
                         "pyarrow, then buffers)")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    used = surface(args.surface)
    if used == "polars":
        matches = with_polars(device)
    elif used == "pyarrow":
        print("(polars not installed; using the Arrow surface)")
        matches = with_arrow(device)
    else:
        print("(polars and pyarrow not installed; using the Arrow buffer "
              "surface)")
        matches = with_buffers(device)
    idx, scores = with_numpy(device)
    return {"device": device.type, "surface": used, "matches": matches,
            "indices": idx, "scores": scores}


if __name__ == "__main__":
    main()
