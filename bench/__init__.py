"""Benchmark of the PyTorch/CUDA port (``repro_torch``): MESC serving of
full-width models on one NVIDIA H100, driven by ``BENCHMARK.json``.

Run one cell from the root of a checkout::

    python3 -m bench.run --workload llava34b.longdoc4k --seed 7 \
        --seconds 51 --trace 0

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name: ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json`` and ``bench/metrics/<metric>.py``.
"""
