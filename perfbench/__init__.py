"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once (``python3 perfbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``); ``README.md`` says how
cells, configurations, traffic kinds and per-layer metrics are added as
files.  Nothing here imports JAX or the JAX package ``repro``.
"""
