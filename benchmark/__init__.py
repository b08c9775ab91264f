"""The benchmark of moca_tpu_torch (the PyTorch/CUDA port) on NVIDIA H100s.

`python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json; `python3 -m benchmark.catalog` lists what the
harness finds by name. Imports nothing of JAX or the JAX package.
"""
