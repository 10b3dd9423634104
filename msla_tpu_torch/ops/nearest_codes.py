"""Index of the L2-nearest codebook row for each input row.

Port of msla_tpu/ops/vq_pallas.py (``nearest_codes_pallas``). On a CUDA tensor
``nearest_codes`` launches the hand-written kernel ``csrc/nearest_codes.cu``
(3xTF32 on the tensor cores, ``csrc/vq_search.cuh``), which never
materialises the (N, K) distance matrix; on a CPU tensor it runs
``nearest_codes_ref``. Both compute dist = ‖e‖² − 2·x·e (‖x‖² is constant per
row and dropped) and pick the lowest index on ties.
``nearest_codes_3xtf32_ref`` emulates the kernel's products for the tests and
``chip_smoke.py``; no wrapper calls it.
"""
from __future__ import annotations

import collections

import torch

from msla_tpu_torch.ops._build import (SMEM_BYTES, check, count_launch, kernel, require,
                                       runs_plain, stream_of)
from msla_tpu_torch.ops.tf32 import product_3xtf32

#: the row width the CUDA kernel is compiled for (the model's embedding_dim)
D = 64
_REF_ROWS = 1 << 16    # rows per chunk of the plain version: a 128 MB block at K=512
_GROUP = 32            # the search's codes a group: K is padded to a multiple
_X_TILES = 8 * 32 * D  # the search's x tiles: 8 warps x 32 rows, fp32


def search_smem_bytes(k: int, with_hist: bool = False) -> int:
    """Shared memory of the search (``vq_search::smem_bytes``): the codebook
    and ‖e‖² padded to a multiple of 32 codes, 8 warps' x tiles and, for #4,
    its histogram (``with_hist``, with ``flush_block``'s 64 static bytes)."""
    kpad = -(-k // _GROUP) * _GROUP
    return 4 * (kpad * (D + 1 + with_hist) + _X_TILES) + 64 * with_hist


def code_norms(codebook: torch.Tensor) -> torch.Tensor:
    """‖e_k‖², shared by the kernel and its plain version."""
    return (codebook * codebook).sum(dim=1)


def nearest_codes_ref(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain version, in row chunks so the distance block stays bounded."""
    e2 = code_norms(codebook)
    out = [torch.argmin(e2 - 2.0 * (chunk @ codebook.T), dim=1)
           for chunk in flat_x.split(_REF_ROWS)]
    return torch.cat(out).to(torch.int32)


def nearest_codes_3xtf32_ref(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The ids as the kernel computes them: dist = ‖e‖² − 2·x·e with x·e in
    3xTF32 (``product_3xtf32``: every operand split into TF32 parts, lo·hi,
    hi·lo and hi·hi a k8 step), then the first index of the minimum. The
    kernel groups the depth's k8 steps in another order of the same products
    (``csrc/vq_search.cuh``) and its accumulator rounds otherwise, so a
    near-tie may go either way between the two."""
    e2 = code_norms(codebook)
    out = [torch.argmin(e2 - 2.0 * product_3xtf32(chunk, codebook.T), dim=1)
           for chunk in flat_x.split(_REF_ROWS)]
    return torch.cat(out).to(torch.int32)


def nearest_codes(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, D) fp32 × (K, D) fp32 → (N,) int32 nearest-codebook indices."""
    if runs_plain("nearest_codes", flat_x, codebook):
        return nearest_codes_ref(flat_x, codebook)

    n = flat_x.shape[0]
    k = codebook.shape[0]
    require("nearest_codes", flat_x, "flat_x", (n, D))
    require("nearest_codes", codebook, "codebook", (k, D))
    if k % 2 or search_smem_bytes(k) > SMEM_BYTES:
        raise ValueError(f"nearest_codes: the kernel takes an even number of codes "
                         f"up to 640 (the codebook in shared memory), got K={k}")
    e2 = code_norms(codebook)
    idx = torch.empty((n,), dtype=torch.int32, device=flat_x.device)
    check("nearest_codes", kernel("nearest_codes_fwd")(
        flat_x.data_ptr(), codebook.data_ptr(), e2.data_ptr(), idx.data_ptr(),
        n, k, stream_of(flat_x)))
    count_launch(nearest_codes, torch.float32)
    return idx


nearest_codes.launches = collections.Counter()
