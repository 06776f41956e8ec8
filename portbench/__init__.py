"""The port's benchmark: ``python3 portbench/run.py --workload <cell>``.

Everything here is data-driven by ``BENCHMARK.json``: a configuration,
a traffic mix, a window driver and each metric are files of their own,
found by name (see README.md)."""
