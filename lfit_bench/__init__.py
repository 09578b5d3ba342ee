"""The benchmark of lfit_python_tpu_torch: one run of one cell a process
(``python3 -m lfit_bench.run``); see ``run.py``."""
