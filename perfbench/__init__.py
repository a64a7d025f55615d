"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once on the card and prints its result
as the last line of standard output.
"""
