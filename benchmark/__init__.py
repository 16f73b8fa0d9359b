"""The benchmark of cdae_tpu_torch on one CUDA card.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything a cell names is a file found by name:
configurations (``configs/``), traffic mixes (``traffic/``), correctness
limits (``limits/``), per-layer metric readers (``metrics/``), and the
code those data files name: the model a configuration runs
(``models/``), the laws its data follow (``laws/``), the driver a traffic
mix runs (``drivers/``), the plain reference that decides ``correct``
(``reference/``). ``harness/`` is the general code that reads them.
"""
