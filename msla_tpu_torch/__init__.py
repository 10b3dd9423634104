"""msla_tpu_torch — the PyTorch/CUDA port of msla_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. This slice
runs VQ-VAE source separation (``inference.SourceSeparator``) through three
hand-written CUDA kernels (``ops/``): the fused encoder stem, the fused
decoder stem and the nearest-code lookup. Entry points run on the card unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch version
runs instead.
"""

__version__ = "0.1.0"
