"""The benchmark of the PyTorch and CUDA port, imsim_tpu_torch.

`python3 portbench/run.py --workload <config>.<mix> --seed <n>
--seconds <s> --trace <0|1>` runs one cell once on the machine's card
and prints one JSON line (BENCHMARK.json holds the cells and metrics).
"""
