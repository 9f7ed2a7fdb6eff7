"""The benchmark of modulatedgps_tpu_torch on one NVIDIA H100.

``python3 torchbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything of one configuration, traffic mix or metric sits in
a file of its own, found by its name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py``, ``reference/<config>.py``,
``work/<config>.py`` and ``limits/<cell>.json``.
"""
