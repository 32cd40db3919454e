"""The benchmark of the PyTorch and CUDA port, ``fiesta_tpu_torch``.

``python3 -m esdfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card.
Everything a cell is made of is a file found by name (``spec.py``):
configurations in ``configs/``, traffic mixes in ``traffic/``, per-layer
metric readers in ``metrics/``, plain references in ``references/``.
Nothing here imports JAX or the JAX package ``fiesta_tpu``; the
references import nothing of the port either.
"""
