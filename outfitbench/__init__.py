"""The benchmark of ``outfitx_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell (a model configuration under one traffic mix)
once and prints one JSON line::

    python3 -m outfitbench.run --workload siglip.train_cp --seed 7 --seconds 10 --trace 0

Everything is found by name: ``BENCHMARK.json`` at the checkout's root
lists the configurations, cells and metrics; ``configs/<config>.json``
holds a configuration's sizes, ``workloads/<cell>.json`` a cell's traffic
and the driver it runs (``drivers/<driver>.py``), and
``metrics/<metric>.py`` reads one per-layer metric from a traced run's
record. The yardstick lives here too: peaks, operation and byte counts
(``peaks.py``, ``flops.py``), the inputs drawn from the seed
(``inputs.py``), the trace's reduction (``trace.py``) and the plain
references that decide ``correct`` (``reference/``). Nothing here
imports ``jax`` or ``outfitx_tpu``; ``reference/`` imports nothing of
``outfitx_tpu_torch`` either.
"""
