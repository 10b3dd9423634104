"""The lean fused-VQ forward (port of ``vq_lean_fwd`` in tools/bench_vq_lean.py).

It computes what ``vq_fused_fwd`` does, with the squared-error sum taken
algebraically, Σ‖q − x‖² = Σ(‖x‖² + min_k(‖e_k‖² − 2·x·e_k)), and no (q − x)²
pass. On CUDA tensors ``vq_lean_fwd`` launches ``csrc/vq_lean.cu`` for the ids,
counts and sum (the search of K3 and #4, 3xTF32 on the tensor cores,
``csrc/vq_search.cuh``), and gathers q = codebook[idx] outside the kernel, as
the JAX function gathers outside its ``pallas_call``; on CPU tensors it runs
``vq_lean_fwd_ref``.

The algebraic form cancels: where q ≈ x a row's two terms are both ≈ ‖x‖², so
its fp32 error is a few units in the last place of ‖x‖², not of the result.
"""
from __future__ import annotations

import collections

import torch

from msla_tpu_torch.ops._build import (SMEM_BYTES, check, count_launch, kernel, require,
                                       runs_plain, stream_of)
from msla_tpu_torch.ops.nearest_codes import _REF_ROWS, D, code_norms, search_smem_bytes
from msla_tpu_torch.ops.vq_fused import count_outputs


def check_codes(k: int) -> None:
    """The kernel's K: #4's rule, an even K whose search fits in shared
    memory with its histogram (``search_smem_bytes``): up to 608."""
    if k % 2 or search_smem_bytes(k, with_hist=True) > SMEM_BYTES:
        raise ValueError(f"vq_lean_fwd: the kernel takes an even number of codes "
                         f"up to 608 (the codebook in shared memory), got K={k}")


def sq_error_bound(flat_x: torch.Tensor) -> float:
    """How far two fp32 computations of the lean sum, in other summation
    orders, may part: each row's ‖x‖² and x·e are D-term fp32 sums of
    terms ≈ ‖x‖²/D, each rounding off ≤ u·‖x‖² (u = 2⁻²⁴); taken as a random
    walk over the D terms and the N rows, 4 standard deviations. The diff²
    form has no such term."""
    n, d = flat_x.shape
    mean_x2 = (flat_x.double() ** 2).sum(dim=1).mean().item() if n else 0.0
    return 4.0 * (n * d) ** 0.5 * 2.0 ** -24 * mean_x2


def vq_lean_fwd_ref(flat_x: torch.Tensor, codebook: torch.Tensor):
    """Plain version: matmul distances in row chunks, their first argmin and
    minimum, ‖x‖² + minimum summed in fp32, ``index_select`` and ``bincount``.
    Returns (q, idx, counts, sq)."""
    e2 = code_norms(codebook)
    ids, sums = [], []
    for chunk in flat_x.split(_REF_ROWS):
        dist = e2 - 2.0 * (chunk @ codebook.T)
        i = torch.argmin(dist, dim=1)
        ids.append(i)
        sums.append((chunk * chunk).sum(dim=1) + dist.gather(1, i[:, None])[:, 0])
    idx = torch.cat(ids).to(torch.int32)
    counts = torch.bincount(idx, minlength=codebook.shape[0]).to(torch.float32)
    return codebook.index_select(0, idx), idx, counts, torch.cat(sums).sum()


def vq_lean_fwd(flat_x: torch.Tensor, codebook: torch.Tensor):
    """(N, D) × (K, D) fp32 → q (N, D) fp32, idx (N,) int32, counts (K,) fp32
    and sq () fp32 = Σ over the rows of ‖x‖² + min_k(‖e_k‖² − 2·x·e_k)."""
    if runs_plain("vq_lean_fwd", flat_x, codebook):
        return vq_lean_fwd_ref(flat_x, codebook)

    n, k = flat_x.shape[0], codebook.shape[0]
    require("vq_lean_fwd", flat_x, "flat_x", (n, D))
    require("vq_lean_fwd", codebook, "codebook", (k, D))
    check_codes(k)
    idx = torch.empty((n,), dtype=torch.int32, device=flat_x.device)
    counts, sq, counts_i, sq_part, parts = count_outputs(k, flat_x.device)
    e2 = code_norms(codebook)
    check("vq_lean_fwd", kernel("vq_lean_fwd")(
        flat_x.data_ptr(), codebook.data_ptr(), e2.data_ptr(), idx.data_ptr(),
        counts.data_ptr(), sq.data_ptr(), counts_i.data_ptr(), sq_part.data_ptr(), parts,
        n, k, stream_of(flat_x)))
    count_launch(vq_lean_fwd, torch.float32)
    return codebook.index_select(0, idx), idx, counts, sq


vq_lean_fwd.launches = collections.Counter()
