"""PyTorch port of ``ance_tpu`` for NVIDIA Hopper (H100).

This package holds the FirstP serving path: the RobertaDot encoder, corpus
encode, the exact ``FlatIPIndex`` (searched through a hand-written CUDA
block-max top-k kernel, ``csrc/blockmax.cu``), the batch and HTTP
retrievers and the ``serve`` CLI. ``ance_tpu`` (JAX) stays the reference
every module here is tested against; this package never imports jax.
"""

import torch

# fp32 matmuls run in full fp32 on the card: the plain phase-1 version the
# kernel is checked against and the fp32 encoder are fp32 computations, as
# the JAX package runs them at "highest" precision (tests/conftest.py:30).
# TF32 keeps ~3 decimal digits and would break both.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
