"""The benchmark of ``gpushare_device_plugin_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. A cell
names a configuration (``configs/<name>.json``), a traffic mix
(``traffic/<name>.json``) and the metrics it reports (``metrics/<name>.py``);
the harness finds each by name, so a new cell, configuration, mix or metric
is new files and entries only. Nothing here imports JAX or the JAX package.
"""
