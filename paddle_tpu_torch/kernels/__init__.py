"""Hand-written CUDA kernels of the port, each in a module beside its
plain PyTorch version (``csrc/`` holds the sources, ``_build`` compiles
them): ``paged_attention``, ``flash_attention`` (forward and backward, and the
small-sequence attention with dropout),
``fused_ln`` (forward and backward), ``layer_norm``, ``fused_adam``,
``dropout``, ``conv_block`` (the conv + batch-norm + relu block),
``fused_momentum``, ``embedding_bag`` and ``channel_stats`` (the column
statistics of a bf16 matrix); ``philox`` is the random stream of the
dropout paths."""
