"""sr3_tpu_torch — the PyTorch / CUDA port of sr3_tpu for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference: the same module
names, the same reference state_dict names, NHWC memory (logical NCHW
tensors in ``torch.channels_last``), and hand-written sm_90a kernels in
``csrc/`` for the six TPU kernels. It imports torch and never jax, and
nothing of ``sr3_tpu``: it keeps its own copies of the numpy-only host code
it needs (config, metrics, dataset, checkpoint key map).
"""
