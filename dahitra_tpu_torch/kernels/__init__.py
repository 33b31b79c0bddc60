"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``fused_tokenizer``: the semantic tokenizer (K3; replaces
  dahitra_tpu/pallas/fused_tokenizer.py ``_tokenizer_kernel``).
* ``folded_decoder``: the decoder-stack forward without and with saves
  (K1; replaces dahitra_tpu/pallas/folded_decoder.py ``_fwd_kernel``) and
  its backward (K2; replaces ``_bwd_kernel``).
* ``fused_decoder``: the fused decoder stack of
  ``TransformerDecoder(pallas=True)`` (K4; replaces
  dahitra_tpu/pallas/fused_decoder.py ``_decoder_kernel``), with the JAX
  package's plain-stack backward.

A wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises. Kernels build at first launch, so
importing this package needs neither nvcc nor a card.
"""
from dahitra_tpu_torch.kernels import (folded_decoder, fused_decoder,
                                       fused_tokenizer)

__all__ = ["folded_decoder", "fused_decoder", "fused_tokenizer"]
