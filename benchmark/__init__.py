"""The benchmark of ``nowcastautogp_tpu_torch`` on NVIDIA cards.

``run.py`` runs one cell of ``BENCHMARK.json`` once; see ``PERF.md``.
"""
