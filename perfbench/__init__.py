"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; everything a cell
needs is found by name under this folder: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``driver`` names a module of
``drivers/``), ``checks/<workload>.json`` (the limits of the comparison
that decides ``correct``) and ``metrics/<metric>.py`` (one reader per
per-layer metric).  ``reference/`` is the plain reference the program is
judged against; it imports nothing of the program.
"""
