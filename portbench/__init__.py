"""The benchmark of swift_game_engine_tpu_torch on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the repository's ``BENCHMARK.json``; see
``portbench/README.md``. This package imports torch, numpy and the port
(``swift_game_engine_tpu_torch``), never jax and never the JAX package.
"""
