"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` is the entry; ``BENCHMARK.json`` at the root of the repository
names the cells. Everything here is the yardstick: the traffic generator,
the plain reference (``reference/``), the comparison that decides
``correct``, the roofline and peak arithmetic, and one reader per
per-layer metric (``metrics/``). Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of the port.
"""
