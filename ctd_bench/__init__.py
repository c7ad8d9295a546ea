"""Benchmark of the PyTorch and CUDA port (``comic_text_detector_tpu_torch``).

``python3 ctd_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell uses is found by name: its configuration in
``configs/``, its traffic mix in ``traffic/``, its limits in ``limits/``,
its loop (named by the mix) in ``loops/`` and each per-layer metric's
reader in ``metrics/``.
"""
