"""Sinusoidal positional encoding (port of msla_tpu/nn/positional.py;
reference: src/model/transformer.py:212-225).

``mode="reference"`` keeps the reference's quirk: it slices ``pe[:, :x.size(1)]``
of a sequence-first tensor, whose dim 1 is the batch, so sample b gets pe[b]
at every position, and the batch may not exceed ``max_len``.
``mode="standard"`` adds pe[s] at position s. The table is built, not
learned, and stays out of the state_dict, as the flax module holds no param.

In a data-parallel step (``parallel.mesh.data_axis``) the quirk's b is the
sample's place in the global batch, as in the JAX step on the global array:
the data index r's j-th row is the global batch's row j·N + r (N the data
size, the loaders' interleave), so N ranks add what one process adds at N
times the batch.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from msla_tpu_torch.parallel.mesh import data_info, sharded


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int, max_len: int = 10000, mode: str = "reference", *,
                 device=None):
        super().__init__()
        if mode not in ("reference", "standard"):
            raise ValueError(f"positional mode {mode!r}: 'reference' or 'standard'")
        self.mode = mode
        self.register_buffer("pe", torch.from_numpy(sinusoidal_table(max_len, d_model)).to(device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, D) batch-first."""
        b, s, _ = x.shape
        index, size = data_info() if self.mode == "reference" and sharded() else (0, 1)
        n = b * size if self.mode == "reference" else s
        if n > self.pe.shape[0]:
            raise ValueError(f"{self.mode} positional encoding of {n} rows from a table of "
                             f"{self.pe.shape[0]}")
        if self.mode == "reference":   # pe[b] at every position (the quirk)
            rows = self.pe[index::size][:b] if size > 1 else self.pe[:b]
            return x + rows[:, None, :]
        return x + self.pe[:s][None, :, :]
