"""The benchmark of the PyTorch and CUDA port, ``sr3_tpu_torch``: one
command runs one cell (``python -m portbench.run``); configurations,
traffic mixes, limits and per-layer metrics are files found by name."""
