"""msla_tpu_torch — the PyTorch/CUDA port of msla_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It runs
VQ-VAE source separation (``inference.SourceSeparator``), VQ-VAE training
(``train.Trainer``) and Audio-BERT serving (``inference.AudioGenerator``)
through hand-written CUDA kernels (``ops/``, ``csrc/``), from WAV files on
disk (``data/``) and from the command line, ``python -m msla_tpu_torch
<overrides>`` (``main.py``). Entry points run on the card unless the caller
passes ``device="cpu"`` (the command line: ``trainer.accelerator=cpu``), where
each kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"
