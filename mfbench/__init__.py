"""The benchmark of ``monoflex_tpu_torch`` on one NVIDIA H100.

``python3 mfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Everything
that measures lives here and is found by name: a configuration in
``configs/<config>.json``, a traffic mix in ``traffic/<traffic>.json`` (data
for the one generator, ``feeds.py``), a per-layer metric in
``metrics/<metric>.py``, a cell's correctness limits in
``limits/<cell>.json``.  ``reference/`` is the frozen plain model it is
judged against.  Nothing here imports jax or the JAX package.
"""
