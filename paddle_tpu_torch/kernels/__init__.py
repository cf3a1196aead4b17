"""Hand-written CUDA kernels of the port, each in a module beside its
plain PyTorch version (``csrc/`` holds the sources, ``_build`` compiles
them): ``paged_attention``, ``flash_attention``, ``fused_ln`` and
``layer_norm``."""
