"""dlsg_tpu_torch — the D-LSG captioning system in PyTorch for NVIDIA Hopper.

A port of the JAX package `dlsg_tpu`, which stays the numerical reference.
Plain tensor code is PyTorch; the two Pallas TPU kernels of the JAX package
are hand-written CUDA C++ kernels (`csrc/`, built with nvcc for sm_90a at
first use and bound with ctypes).

Subpackages
-----------
- ``config``     : DLSGConfig (same fields and defaults as dlsg_tpu.config),
                   derived paths, parse_opt
- ``vocab``      : Vocabulary, special-token ids, reference-pkl import
- ``bundle``     : single-file serving bundles (format shared with dlsg_tpu)
- ``weights``    : flax parameter tree <-> torch state_dict
- ``ops``        : LSTM primitives, exact top-k, beam search, Dense/LayerNorm,
                   dropout, losses (WGAN-GP)
- ``kernels``    : CUDA kernels (lstm_scan, vocab_head) with plain versions
- ``models``     : CapGnnModel and the baseline generators (CapModel,
                   CapBaseline1, CapBaselineModel; encoders, decoder, shared
                   layers), DiscV2, GloVe import
- ``train``      : Adam train states, schedules, the GAN-lambda machine, the
                   CE and WGAN-GP train steps, the RunGAN, Run and RunLegacy
                   trainers
- ``data``       : HDF5/pickle readers, batchers, a worker-process pool,
                   host -> device prefetch, synthetic data
- ``metrics``    : PTB tokenizer, BLEU, METEOR, ROUGE-L, CIDEr, COCOScorer
- ``native``     : the C++ PTB tokenizer, stemmer and METEOR aligner (g++ at
                   first use, ctypes)
- ``evaluation`` : greedy, beam and two-pass decode functions, evaluate()
                   with scoring, best-result tracking
- ``checkpoint`` : best-model and per-epoch training checkpoints, resume
- ``convert``    : reference-trained torch .pt -> this package's state_dict
- ``parallel``   : data parallelism over torch.distributed (one process per
                   card): gradient all-reduce, global-batch sums, eval gather
- ``utils``      : scalar logging, Stopwatch and torch.profiler traces,
                   attention heatmaps
- ``serve``      : load-once Captioner (bucketed batches, warmup)
- ``server``     : the HTTP captioning service over a Captioner
- ``cli``        : ``python -m dlsg_tpu_torch.cli
                   train|train-base|train-legacy|evaluate|serve|export``

Entry points run on `cuda` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
