"""Task modules of the port."""
from msla_tpu_torch.models.vqvae import VQVAETask

__all__ = ["VQVAETask"]
