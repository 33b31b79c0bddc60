"""DAHiTra in PyTorch for an NVIDIA H100: the port of ``dahitra_tpu``.

The JAX package ``dahitra_tpu`` stays the reference; this package computes
the same functions with PyTorch and hand-written CUDA kernels for Hopper
(``csrc/``, built with ``nvcc`` into ``build/`` at first use). It imports
neither JAX nor ``dahitra_tpu``.

Slice 1 covers the LEVIR-CD evaluation path of the paper model
``newUNetTrans``: ``python -m dahitra_tpu_torch.cli.eval_cd``. Public
functions keep the JAX layouts: NHWC images and (B, N, C) sequences.
"""

__version__ = "0.1.0"
