"""dlsg_tpu_torch — the D-LSG captioning system in PyTorch for NVIDIA Hopper.

A port of the JAX package `dlsg_tpu`, which stays the numerical reference.
Plain tensor code is PyTorch; the two Pallas TPU kernels of the JAX package
are hand-written CUDA C++ kernels (`csrc/`, built with nvcc for sm_90a at
first use and bound with ctypes).

Subpackages
-----------
- ``config``     : DLSGConfig (same fields and defaults as dlsg_tpu.config)
- ``vocab``      : Vocabulary and special-token ids
- ``bundle``     : single-file serving bundles (format shared with dlsg_tpu)
- ``weights``    : flax parameter tree <-> torch state_dict
- ``ops``        : LSTM primitives, exact top-k, beam search, Dense/LayerNorm
- ``kernels``    : CUDA kernels (lstm_scan, vocab_head) with plain versions
- ``models``     : CapGnnModel (encoders, decoder, shared layers)
- ``evaluation`` : greedy and beam decode functions
- ``serve``      : load-once Captioner (bucketed batches, warmup)

Entry points run on `cuda` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
