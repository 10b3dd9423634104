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

Widths: any D from 1 to 512 and K from 1 to 65,536. The forward runs the
search ``nearest_codes.plan_search`` picks (the tuned kernels at D in
``nearest_codes.WIDTHS``, ``csrc/vq_any.cu`` elsewhere, whose counts go to
integer atomics in device memory). The codebook gradient runs its 64-column
kernel over ⌈D / 64⌉ column slices (the last one's columns past D read as
zeros; rows padded to 4 columns where D % 4 != 0), and over runs of at most
``GRAD_RUN`` codes where K exceeds them, each run a launch on the same grid
(``plan_grad``). Other widths raise ``ValueError`` on a CUDA tensor.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch
import torch.nn.functional as F

from msla_tpu_torch.ops import segment_sum
from msla_tpu_torch.ops._build import (SMEM_BYTES, aligned, check, count_launch, kernel,
                                       require, runs_plain, sm_count, stream_of)
from msla_tpu_torch.ops.nearest_codes import (MAX_D, MAX_K, code_norms, nearest_codes_ref,
                                              plan_search)


def grad_smem_bytes(k: int) -> int:
    """Shared memory of the codebook-gradient kernel at K codes a launch
    (``csrc/segment_sum.cuh``): the (K + 1, 64) fp32 accumulator and three
    TMA stages of 64 rows; K up to 701 fits (``GRAD_RUN``)."""
    return segment_sum.smem_bytes(k, split2=False)


#: the most codes one launch of the gradient takes: its accumulator's rows
GRAD_RUN = max(k for k in range(1, 1024)
               if segment_sum.smem_bytes(k, split2=False) <= SMEM_BYTES)


class GradPlan(NamedTuple):
    """How #5 runs at (K, D): codes a launch (``run``) and the launches, the
    row width it reads (D padded to 4), its 64-column slices, and the share
    of its adds on columns past D (zeros)."""
    run: int
    runs: int
    width: int
    slices: int
    padded_share: float


def plan_grad(k: int, d: int) -> GradPlan:
    """#5's launches at K codes of width d. Raises ``ValueError`` past the
    search's limits (``nearest_codes.MAX_D``, ``MAX_K``)."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"vq_codebook_grad: D={d} outside the kernels' limit, D from 1 to "
                         f"{MAX_D}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"vq_codebook_grad: K={k} outside the kernels' limit, K from 1 to "
                         f"{MAX_K}")
    run = min(k, GRAD_RUN)
    width = -(-d // 4) * 4
    slices = -(-width // segment_sum.SLICE)
    return GradPlan(run, -(-k // run), width, slices, 1 - d / (slices * segment_sum.SLICE))


def grad_layout(n: int, k: int, d: int, dev: torch.device) -> tuple[int, int]:
    """(clusters, rows_per_part) of each of #5's launches over N rows: those
    of a run of ``plan_grad``'s codes, the same for every run, so that
    ``codebook_grad_order_ref`` at clusters x 4 blocks is their order."""
    plan = plan_grad(k, d)
    return segment_sum.launch_layout("vq_codebook_grad", n, plan.run, dev, split2=False,
                                     slices=plan.slices)


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

    n = flat_x.shape[0]
    k, d = codebook.shape
    plan = plan_search(k, d, with_hist=True, name="vq_fused_fwd")
    require("vq_fused_fwd", flat_x, "flat_x", (n, d))
    require("vq_fused_fwd", codebook, "codebook", (k, d))
    dev = flat_x.device
    q = torch.empty((n, d), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    counts, sq, counts_i, sq_part, parts = count_outputs(k, dev)
    e2 = code_norms(codebook)
    args = (flat_x.data_ptr(), codebook.data_ptr(), e2.data_ptr(), q.data_ptr(), idx.data_ptr(),
            counts.data_ptr(), sq.data_ptr(), counts_i.data_ptr(), sq_part.data_ptr(), parts, n,
            k, d)
    if plan.design == "any width":
        status = kernel("vq_any_fwd")(*args, plan.rows, plan.codes, stream_of(flat_x))
    else:
        status = kernel("vq_fused_fwd")(*args, stream_of(flat_x))
    check("vq_fused_fwd", status)
    count_launch(vq_fused_fwd, torch.float32, (d, k))
    return q, idx, counts, sq


def vq_codebook_grad_ref(g: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: one ``index_add_``."""
    return torch.zeros((k, g.shape[1]), dtype=g.dtype, device=g.device).index_add_(
        0, idx.long(), g)


def vq_codebook_grad(g: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """(N, D) fp32 gradients and (N,) int32 ids → (K, D) fp32 per-code sums."""
    if runs_plain("vq_codebook_grad", g, idx):
        return vq_codebook_grad_ref(g, idx, k)

    n, d = g.shape
    plan = plan_grad(k, d)
    require("vq_codebook_grad", g, "g", (n, d))
    require("vq_codebook_grad", idx, "idx", (n,), torch.int32)
    dev = g.device
    if plan.width != d:  # rows of 16-byte multiples for the TMA copies: zero columns
        g = F.pad(g, (0, plan.width - d))
    g, idx = aligned(g), aligned(idx)
    clusters, rows = grad_layout(n, k, d, dev)
    dcb = torch.empty((k, plan.width), dtype=torch.float32, device=dev)
    partials = torch.empty((plan.slices, clusters, plan.run, segment_sum.SLICE),
                           dtype=torch.float32, device=dev)  # scratch, shared by the runs
    for code0 in range(0, k, plan.run):
        check("vq_codebook_grad", kernel("vq_codebook_grad")(
            g.data_ptr(), idx.data_ptr(), dcb.data_ptr() + 4 * code0 * plan.width,
            partials.data_ptr(), clusters, rows, n, code0, min(plan.run, k - code0), plan.width,
            stream_of(g)))
        count_launch(vq_codebook_grad, torch.float32, (d, k))
    if plan.width != d:
        dcb = dcb[:, :d].contiguous()
    return dcb


for _wrapper in (vq_fused_fwd, vq_codebook_grad):
    _wrapper.launches, _wrapper.widths = collections.Counter(), collections.Counter()
