"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command,
``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``, driven by ``BENCHMARK.json`` and the files under this folder."""
