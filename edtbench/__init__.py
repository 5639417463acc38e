"""The benchmark of ``edt_tpu_torch`` on one NVIDIA H100, driven by
``BENCHMARK.json`` at the root of the checkout.

    python3 -m edtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

- ``run``: one run of a cell, its result line.
- ``spec``: the cells, resolved by name to ``configs/``, ``traffic/`` and
  ``metrics/`` (a reader a metric, or one for every suffix of a name).
- ``ranks``: a cell over several cards, one process a card.
- ``volumes``, ``loops``: the inputs made from the seed, and the one
  traffic generator (a closed loop of the program's calls).
- ``reference``: the plain reference that decides ``correct``.
- ``trace``, ``roofline``: the traced window's device events, and the
  kernels' bytes, operations and the card's peaks.
- ``control``: the readings the limits of ``correct`` were set from.

It imports nothing of JAX or the JAX package; the reference imports
nothing of the program.
"""
