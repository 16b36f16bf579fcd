"""se3diff_torch: the SE(3) diffusion ensemble sampler in PyTorch, with its
IPA attention core as a hand-written CUDA kernel for NVIDIA Hopper.

A port of ``se3diff_tpu`` (JAX/TPU), which stays the reference; the module
layout mirrors it. Entry points run on ``cuda`` unless the caller asks for
the CPU.
"""

__version__ = "0.1.0"
