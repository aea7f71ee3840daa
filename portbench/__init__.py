"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that measures (traffic, weights, counts of
operations and bytes, the device-trace arithmetic, the plain reference and
the comparison that decides ``correct``) is this package's own; from the
port it takes only the system under test. See ``portbench/README.md``.
"""
