"""The JAX package's ``examples/`` on the PyTorch / CUDA port.

Seven scripts, each a module with ``main(argv=None)`` that parses the
JAX script's arguments (plus ``--cpu``), prints what the JAX script
prints, and returns a dict of it:

- ``quickstart``: the README walkthrough (Polars, Arrow or raw buffers,
  then NumPy);
- ``serving``: a resident corpus serving filtered batches, mutations,
  save / load at int8, and a ``ClusteredCorpus`` through drift and
  ``rebuild``;
- ``benchmark_topk``: the ten sweeps around 1000 x 10,000 x 256 against
  a NumPy top-k, each result checked against it first;
- ``benchmark_matmul``: ``matmul`` at 1000 x 10,000 x 256, f32 and f64,
  from NumPy, FixedSizeList and List columns (``pyarrow`` arrays where it
  imports, the raw-buffer layer otherwise);
- ``benchmark_bigcorpus``: 2M x 256 in the four storage tiers with kernel
  A's carry gate on and off;
- ``benchmark_clustered``: probed search over a 2M x 256 blob mixture at
  several probe fractions, recall against the exhaustive scan, then
  drift and ``rebuild``;
- ``benchmark_scaling``: 1.25M x 768 f32 at k=100 on meshes of 1, 2 and
  4 shards, both merges.

Run one on the card (the default; with no card it raises):

    python -m polars_matmul_tpu_torch.examples.serving

or on the CPU, where every kernel wrapper runs its plain PyTorch version:

    python -m polars_matmul_tpu_torch.examples.serving --cpu

Nothing here imports JAX or the JAX package.  Times are the port's own:
a call's host time (results on the host) and its device time (CUDA
events, or a CUDA graph of calls) carry separate names.
"""
