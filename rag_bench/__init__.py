"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell: ``python3 rag_bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.  See ``README.md``."""
