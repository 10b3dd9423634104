"""Index of the L2-nearest codebook row for each input row.

Port of msla_tpu/ops/vq_pallas.py (``nearest_codes_pallas``). On a CUDA tensor
``nearest_codes`` launches the hand-written kernel ``csrc/nearest_codes.cu``
(3xTF32 on the tensor cores, ``csrc/vq_search.cuh``), which never
materialises the (N, K) distance matrix; on a CPU tensor it runs
``nearest_codes_ref``. Both compute dist = ‖e‖² − 2·x·e (‖x‖² is constant per
row and dropped) and pick the lowest index on ties.
``nearest_codes_3xtf32_ref`` emulates the kernel's products for the tests and
``chip_smoke.py``; no wrapper calls it.

Widths: the kernels take D in ``WIDTHS``, the embedding widths of
configs/hparams_search/optuna.yaml: D = 64 (the default) with the codebook
held in shared memory, an even K up to 640; D = 128 and 256 with the
codebook streamed through a ring of stages (``csrc/vq_stream.cuh``), any even
K (#4's forward, whose histogram stays in shared memory: up to 24,744 and
8,344; ``search_smem_bytes``). Other widths raise ``ValueError`` on a CUDA
tensor; the plain versions take any.
"""
from __future__ import annotations

import collections

import torch

from msla_tpu_torch.ops._build import (SMEM_BYTES, check, count_launch, kernel, refuse_widths,
                                       require, runs_plain, stream_of)
from msla_tpu_torch.ops.tf32 import product_3xtf32

#: the default row width (the model's embedding_dim), whose search holds the codebook
D = 64
#: the row widths the CUDA kernels are compiled for
WIDTHS = (D, 128, 256)
_REF_ROWS = 1 << 16    # rows per chunk of the plain version: a 128 MB block at K=512
_GROUP = 32            # the search's codes a group: K is padded to a multiple at D = 64
# the streamed search (csrc/vq_stream.cuh): columns a stage (DS), its stages
# (STAGES), a block tile's rows (TILE_ROWS: 4 slabs of 32) and a stage's
# codes (STAGE_CODES: 2 warps a slab, 64 codes each)
_SLICE, _RING, _TILE_ROWS, _STAGE_CODES = 16, 4, 128, 128


def search_smem_bytes(k: int, with_hist: bool = False, d: int = D) -> int:
    """Shared memory of a block of the search at K codes of width d, as
    ``csrc/nearest_codes.cu``'s ``vq_search_smem_bytes`` reports it. At D = 64
    (``vq_search::smem_bytes``): the codebook and ‖e‖² padded to a multiple
    of 32 codes and 8 warps' x tiles; wider (``vq_stream::smem_bytes``): 128
    bytes to align, the block tile's x, the ring's hi and lo planes, the
    merge of a slab's two warps (8 warps x 32 rows x 8 bytes), 3 mbarriers a
    stage and one an x slice, with no ‖e‖² and no codebook, so K3 takes any
    K. For #4 also its histogram (``with_hist``) and an fp64 partial for
    each of its 8 searching warps (64 static bytes)."""
    if d == D:
        kpad = -(-k // _GROUP) * _GROUP
        return 4 * (kpad * (d + 1 + with_hist) + 8 * 32 * d) + 64 * with_hist
    slices = d // _SLICE
    fixed = (128 + slices * _TILE_ROWS * _SLICE * 4 + _RING * 2 * _STAGE_CODES * _SLICE * 4
             + 8 * 32 * 8 + (3 * _RING + slices) * 8)
    return fixed + (4 * k + 64) * with_hist


def check_codes(name: str, k: int, d: int, with_hist: bool) -> None:
    """Raise ``ValueError`` unless the search of ``name`` takes K codes of
    width d: d in ``WIDTHS``, K even and within shared memory."""
    refuse_widths(name, (d,), [(w,) for w in WIDTHS])
    if k < 2 or k % 2 or search_smem_bytes(k, with_hist, d) > SMEM_BYTES:
        raise ValueError(f"{name}: the kernel takes an even number of codes that fits in "
                         f"shared memory at D={d} (search_smem_bytes), got K={k}")


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
    k, d = codebook.shape
    check_codes("nearest_codes", k, d, with_hist=False)
    require("nearest_codes", flat_x, "flat_x", (n, d))
    require("nearest_codes", codebook, "codebook", (k, d))
    e2 = code_norms(codebook)
    idx = torch.empty((n,), dtype=torch.int32, device=flat_x.device)
    check("nearest_codes", kernel("nearest_codes_fwd")(
        flat_x.data_ptr(), codebook.data_ptr(), e2.data_ptr(), idx.data_ptr(), n, k, d,
        stream_of(flat_x)))
    count_launch(nearest_codes, torch.float32, (d, k))
    return idx


nearest_codes.launches, nearest_codes.widths = collections.Counter(), collections.Counter()
