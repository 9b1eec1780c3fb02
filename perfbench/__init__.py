"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA
H100: ``python3 perfbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout.  See ``bench.py``."""
