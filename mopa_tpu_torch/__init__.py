"""MoPA in PyTorch for NVIDIA Hopper GPUs.

The counterpart of ``mopa_tpu`` (the JAX/TPU reference, which stays the numerics
oracle). Module paths mirror ``mopa_tpu`` so each port lives where its reference
does. This package imports ``torch`` and ``numpy`` only: never ``jax``, ``flax``,
``optax`` or any ``mopa_tpu`` module.

Covered so far: the eval forward of the UNetResNet34 + SCN SparseUNet pair
(``data.utils.validate.make_eval_step``), with the submanifold 3x3x3 conv
forward as a hand-written sm_90a CUDA kernel (``ops.sparse_conv_cuda``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
