"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``fused_tokenizer``: the semantic tokenizer (replaces
  dahitra_tpu/pallas/fused_tokenizer.py ``_tokenizer_kernel``).
* ``folded_decoder``: the decoder-stack forward without and with saves
  (replaces dahitra_tpu/pallas/folded_decoder.py ``_fwd_kernel``) and its
  backward (replaces ``_bwd_kernel``).

A wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.
"""
