"""The benchmark of the PyTorch / CUDA port (`anerf_torch`): one run of
one cell is `python3 benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` (see run.py)."""
