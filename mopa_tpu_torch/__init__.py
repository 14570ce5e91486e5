"""MoPA in PyTorch for NVIDIA Hopper GPUs.

The counterpart of ``mopa_tpu`` (the JAX/TPU reference, which stays the numerics
oracle). Module paths mirror ``mopa_tpu`` so each port lives where its reference
does. This package imports ``torch`` and ``numpy`` only: never ``jax``, ``flax``,
``optax`` or any ``mopa_tpu`` module.

Covered so far: the eval forward of the UNetResNet34 + SCN SparseUNet pair
(``data.utils.validate.make_eval_step``); the shipped MoPA train step, VGI
on host-built plans included, before and after the EMA switch
(``train.trainer.make_train_step``), with the submanifold 3x3x3 conv forward
and backward as hand-written sm_90a CUDA kernels (``ops.sparse_conv_cuda``;
tensor cores in bfloat16) and the gather probes of ``tools.gather_micro``
(``ops.gather``); and the data path that feeds the step: the datasets, the
threaded loaders of ``data.build.build_dataloader`` and the pinned, side-
stream ``train.common.device_prefetch``; and the drivers a user runs: the
training loop ``train.common.train`` with its two-stream ``.pth``
checkpoints (the JAX package's format, so runs resume across the two
packages), ``data.utils.validate.validate``, ``test.test.test_model`` and
the command lines ``train.train_{baseline,xmuda,xmuda_mopa}`` and
``test.test``; and Segment-Anything (``models.sam``: ``SAM``,
``import_sam_checkpoint``, ``generate_mask_id_map``), the offline mask
writer ``data.sam_refine`` and the attention blocks of
``models.attention``; and the other 3D backbones, ``models.spvcnn`` (its
convs on the same kernels, which take any width) and ``models.salsanext``,
with the depth head of ``models.resnet34_unet`` (``TRAIN.DEPTH_PRED``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
