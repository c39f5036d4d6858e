"""The benchmark of ``protoclip_tpu_torch`` on an NVIDIA H100.

One command runs one cell once, from the root of a checkout::

    python3 -m benchmark.run --workload vit-b16.bank-1024 --seed 7 --seconds 20 --trace 0

Everything is found by name from ``BENCHMARK.json``: a configuration is
its file under ``configs/``, a traffic mix its file under ``traffic/``
(which names its driver under ``drivers/``), a cell's comparison limits
its file under ``cells/`` and each metric a reader under ``metrics/``.
The plain reference that decides ``correct`` is ``reference/``; it
imports nothing of the program.  Nothing here imports JAX or the JAX
package ``protoclip_tpu``.
"""
