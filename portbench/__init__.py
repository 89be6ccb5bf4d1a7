"""The benchmark of the PyTorch/CUDA port (`coloc_tpu_torch`): a harness
driven by data. `BENCHMARK.json` at the repository's root names the cells;
each cell's configuration, traffic mix, per-layer metrics and limits are
files found by name under this folder. Run a cell with

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
