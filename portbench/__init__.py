"""The benchmark of `stgcma_tpu_torch` on NVIDIA H100: one cell a run, driven
by `BENCHMARK.json` and the configuration, traffic and metric files under
this directory (`python3 -m portbench.run --help`)."""
