"""The fused training VQ's two kernels (port of msla_tpu/ops/vq_fused.py).

``vq_fused_fwd`` computes, in one pass over the rows, each row's nearest code,
the quantized rows q = codebook[idx], the per-code counts and Σ‖q − x‖².
``vq_codebook_grad`` computes the codebook's gradient through the gather,
dcb = Σᵢ onehot(idxᵢ)ᵀ gᵢ, a segment sum. On CUDA tensors each launches its
hand-written kernel in ``csrc/vq_fused.cu`` (the forward's search in 3xTF32 on
the tensor cores, ``csrc/vq_search.cuh``); on CPU tensors each runs its plain
version (``vq_fused_fwd_ref``, ``vq_codebook_grad_ref``).

The CUDA sums are deterministic and not taken in the TPU kernel's order:
Σ‖q − x‖² from per-block partials reduced in block order, dcb in the order of
``ops/segment_sum.py`` (``codebook_grad_order_ref``), the kernel of
``csrc/segment_sum.cuh``.
"""
from __future__ import annotations

import collections

import torch

from msla_tpu_torch.ops import segment_sum
from msla_tpu_torch.ops._build import (SMEM_BYTES, check, count_launch, kernel, require,
                                       runs_plain, sm_count, stream_of)
from msla_tpu_torch.ops.nearest_codes import D, code_norms, nearest_codes_ref, search_smem_bytes


def grad_smem_bytes(k: int) -> int:
    """Shared memory of the codebook-gradient kernel at K codes
    (``csrc/segment_sum.cuh``): the (K + 1, 64) fp32 accumulator and three
    TMA stages of 64 rows; K up to 701 fits."""
    return segment_sum.smem_bytes(k, split2=False)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes, as a
    TMA copy needs."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def count_outputs(k: int, dev: torch.device):
    """A VQ forward kernel's counts (K,) fp32 and sq () fp32, the integer counts
    and per-block fp64 partials it sums them in (``csrc/vq_common.cuh``), and
    the most blocks it may launch."""
    parts = sm_count(dev)
    return (torch.empty((k,), dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.float32, device=dev),
            torch.empty((k,), dtype=torch.int32, device=dev),
            torch.empty((parts,), dtype=torch.float64, device=dev), parts)


def vq_fused_fwd_ref(flat_x: torch.Tensor, codebook: torch.Tensor):
    """Plain version: matmul distances and argmin (``nearest_codes_ref``),
    ``index_select``, ``bincount`` and a sum. Returns (q, idx, counts, sq)."""
    idx = nearest_codes_ref(flat_x, codebook)
    q = codebook.index_select(0, idx)
    counts = torch.bincount(idx, minlength=codebook.shape[0]).to(torch.float32)
    return q, idx, counts, ((q - flat_x) ** 2).sum()


def vq_fused_fwd(flat_x: torch.Tensor, codebook: torch.Tensor):
    """(N, D) × (K, D) fp32 → q (N, D) fp32, idx (N,) int32, counts (K,) fp32
    and sq () fp32 = Σ‖q − x‖² over the N rows."""
    if runs_plain("vq_fused_fwd", flat_x, codebook):
        return vq_fused_fwd_ref(flat_x, codebook)

    n, k = flat_x.shape[0], codebook.shape[0]
    require("vq_fused_fwd", flat_x, "flat_x", (n, D))
    require("vq_fused_fwd", codebook, "codebook", (k, D))
    if k % 2 or search_smem_bytes(k, with_hist=True) > SMEM_BYTES:
        raise ValueError(f"vq_fused_fwd: the kernel takes an even number of codes "
                         f"up to 608 (the codebook in shared memory), got K={k}")
    dev = flat_x.device
    q = torch.empty((n, D), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    counts, sq, counts_i, sq_part, parts = count_outputs(k, dev)
    e2 = code_norms(codebook)
    check("vq_fused_fwd", kernel("vq_fused_fwd")(
        flat_x.data_ptr(), codebook.data_ptr(), e2.data_ptr(), q.data_ptr(), idx.data_ptr(),
        counts.data_ptr(), sq.data_ptr(), counts_i.data_ptr(), sq_part.data_ptr(), parts,
        n, k, stream_of(flat_x)))
    count_launch(vq_fused_fwd, torch.float32)
    return q, idx, counts, sq


def vq_codebook_grad_ref(g: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: one ``index_add_``."""
    return torch.zeros((k, g.shape[1]), dtype=g.dtype, device=g.device).index_add_(
        0, idx.long(), g)


def vq_codebook_grad(g: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """(N, D) fp32 gradients and (N,) int32 ids → (K, D) fp32 per-code sums."""
    if runs_plain("vq_codebook_grad", g, idx):
        return vq_codebook_grad_ref(g, idx, k)

    n = g.shape[0]
    require("vq_codebook_grad", g, "g", (n, D))
    require("vq_codebook_grad", idx, "idx", (n,), torch.int32)
    if k < 1 or grad_smem_bytes(k) > SMEM_BYTES:
        raise ValueError(f"vq_codebook_grad: K={k} codes do not fit in shared memory "
                         f"(grad_smem_bytes)")
    dev = g.device
    g, idx = aligned(g), aligned(idx)
    clusters, rows = segment_sum.launch_layout("vq_codebook_grad", n, k, dev, split2=False)
    dcb = torch.empty((k, D), dtype=torch.float32, device=dev)
    partials = torch.empty((clusters, k, D), dtype=torch.float32, device=dev)  # scratch
    check("vq_codebook_grad", kernel("vq_codebook_grad")(
        g.data_ptr(), idx.data_ptr(), dcb.data_ptr(), partials.data_ptr(), clusters, rows, n,
        k, stream_of(g)))
    count_launch(vq_codebook_grad, torch.float32)
    return dcb


vq_fused_fwd.launches = collections.Counter()
vq_codebook_grad.launches = collections.Counter()
