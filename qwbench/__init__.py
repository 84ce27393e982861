"""The benchmark of `quickwit_tpu_torch`, the PyTorch/CUDA search engine.

`python -m qwbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json`: it draws the cell's corpus from the seed,
builds and publishes its splits, warms the cell's request shapes, offers the
cell's traffic to `RootSearcher.search` for `--seconds`, checks a sample of
the answers against a plain reference (`qwbench/reference/`) and prints one
JSON line. Everything that belongs to one deployment, traffic mix or
per-layer metric is a file of its own, found by name:

- `configs/<config>.json`: the deployment (corpus sizes, mapping, limits);
- `corpus/<kind>.py`: the seeded generator and split builder of a corpus;
- `traffic/<mix>.json`: the arrival process and the request templates;
- `metrics/<metric>.py`: the reader of one per-layer metric.

Nothing here imports `jax` or the JAX package `quickwit_tpu`.
"""
