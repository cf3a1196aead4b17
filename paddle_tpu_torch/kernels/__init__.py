"""Hand-written CUDA kernels of the port, each in a module beside its
plain PyTorch version (``csrc/`` holds the sources, ``_build`` compiles
them): ``paged_attention``, ``flash_attention`` (forward and backward),
``fused_ln`` (forward and backward), ``layer_norm`` and ``fused_adam``."""
