"""The benchmark of modulatedgps_tpu_torch on NVIDIA H100 cards (one, or
four for a cell whose state is sharded).

``python3 torchbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything of one configuration, traffic mix or metric sits in
a file of its own, found by its name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``harness/<kind>.py`` (the mix's ``kind``),
``metrics/<metric>.py``, ``reference/<config>.py``, ``work/<config>.py``
and ``limits/<cell>.json``.
"""
