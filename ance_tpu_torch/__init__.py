"""PyTorch port of ``ance_tpu`` for NVIDIA Hopper (H100).

The package holds the ANCE system on one device, or data-parallel over
several (``core/mesh.py``, one process a card): MS MARCO preprocessing
(``data/preprocess.py``), the RobertaDot encoders (FirstP ``rdot_nll`` and
MaxP ``rdot_nll_multi_chunk``), corpus encode, the exact ``FlatIPIndex``
(searched through the hand-written CUDA block-max top-k kernel,
``csrc/blockmax.cu``), the batch, HTTP and live retrievers, the train step
with LAMB, the BM25 warmup, the trainer and generator jobs, the
single-program pipelined refresh (``train/pipelined.py``), reading and
resuming the JAX package's checkpoints (msgpack, and orbax's OCDBT / zarr /
zstd layout through ``train/orbax_reader.py``, ``train/ocdbt.py`` and the
C++ zstd decoder ``native/zstd.cpp``) and exporting HF directories. DPR:
``models/dot_models.py::BiEncoder``, ``data/dpr.py``,
``train/dpr_trainer.py`` (the in-batch step, GradCache accumulation),
``train/dpr_gen.py`` and ``evaluation/qa_validation.py``. SEED:
``models/seed.py`` (SeedForMaskedLM, the windowed decoder and its
incremental decode), ``train/seed_pretrain.py``, ``ops/quant_noise.py``,
``data/wordpiece.py`` with its C++ core (``native/wordpiece.cpp``, built
by ``utils/native_build.py``), the fairseq import and export
(``models/weights.py``, ``models/hf_export.py``). The CLI has the JAX
CLI's 13 subcommands: ``preprocess``, ``preprocess-dpr``, ``warmup``,
``train``, ``generate``, ``generate-dpr``, ``infer``, ``ance-loop``,
``seed-pretrain``, ``serve``, ``export-hf``, ``eval``, ``eval-full``. The
attention kernels are CUDA C++ too (``csrc/``). ``ance_tpu`` (JAX) stays
the reference every module here is tested against; this package never
imports jax, flax, msgpack, orbax, tensorstore or zstandard.
"""

import torch

# fp32 matmuls run in full fp32 on the card: the plain phase-1 version the
# kernel is checked against and the fp32 encoder are fp32 computations, and
# the CPU parity tests hold them to the JAX package run at "highest"
# precision. That precision is pinned only in the JAX package's tests
# (tests/conftest.py:30) and its loss matmuls (ance_tpu/models/losses.py:
# 22-24); its encoder's Dense layers run at the platform's default
# precision (ROADMAP Queue 3, "Differs from the reference"). TF32 keeps ~3
# decimal digits and would break the kernel checks.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
