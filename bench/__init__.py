"""The benchmark of the PyTorch/CUDA port (``repro_torch``): many PopPy
compound-AI programs at once on one ``ServingEngine``.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything
that belongs to one configuration (``configs/``), one traffic mix
(``mixes/``), one metric (``metrics/``) or one cell's correctness limits
(``limits/``) is a file of its own, found by the name in
``BENCHMARK.json``.
"""
