"""Task modules of the port."""
from msla_tpu_torch.models.bert import AudioBertTask
from msla_tpu_torch.models.vqvae import VQVAETask

__all__ = ["AudioBertTask", "VQVAETask"]
