"""audio_sheet_retrieval_tpu — audio–sheet-music retrieval framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
CPJKU/audio_sheet_retrieval (TISMIR 2018): twin convolutional encoders for
sheet-music snippets and log-filterbank spectrogram excerpts, trained with a
pairwise ranking loss on top of a CCA projection into a shared 32-D embedding
space, plus retrieval/piece-identification services, CCA refinement, OMR, and
audio-to-sheet alignment.

Design:
  * all compute paths are jit-compiled XLA (encoders, CCA whitening/eigh,
    gallery matmul+top-k, spectrogram front-end),
  * multi-device scaling via ``jax.sharding.Mesh`` + NamedSharding
    (data-parallel training, gallery-sharded retrieval, psum'd covariance
    statistics).

Reference parity notes cite files in the upstream repo as
``reference:<path>:<line>`` (mounted read-only during development).
"""

__version__ = "0.1.0"
