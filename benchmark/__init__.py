"""Benchmark of tpu_locoman_torch, the PyTorch and CUDA MPC: one cell per
run, ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``BENCHMARK.json`` at the root of the repository."""
