"""Layout bridge for the tests that hold msla_tpu_torch against msla_tpu.

The JAX package is NWC with flax kernels; the port is NCW with torch weights.
"""
import numpy as np
import torch


def ncw(a) -> torch.Tensor:
    """NWC array (B, W, C) → torch (B, C, W), float32, CPU."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(a, np.float32), 1, 2)))


def torch_weight(k) -> torch.Tensor:
    """flax conv kernel (k, in, out) → Conv1d (out, in, k); flax ConvTranspose
    (transpose_kernel=True) kernel (k, out, in) → ConvTranspose1d (in, out, k).
    Reversing the axes is the map for both."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).transpose(2, 1, 0)))


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))
