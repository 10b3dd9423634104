"""msla_tpu_torch — the PyTorch/CUDA port of msla_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It runs
VQ-VAE source separation (``inference.SourceSeparator``), VQ-VAE training
(``train.Trainer``) and Audio-BERT serving (``inference.AudioGenerator``)
through hand-written CUDA kernels (``ops/``, ``csrc/``). Entry points run on
the card unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.
"""

__version__ = "0.1.0"
