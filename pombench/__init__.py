"""The benchmark of the PyTorch and CUDA port (``extpom_tpu_torch``).

``python -m pombench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output (``pombench/README.md``).
Nothing here imports JAX or the JAX package; the port is imported only by
:mod:`pombench.program`, and the plain reference that decides ``correct``
(:mod:`pombench.reference`) imports nothing of it.
"""
