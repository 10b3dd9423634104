"""Precision variants of the fused VQ forward and of its codebook gradient
(port of ``make_fwd`` and ``make_bwd`` in tools/bench_vq_precision.py).

The forward's ``dist_mode`` is the distance dot x·e in ``"f32"``, in
``"bf16"`` (bf16(x)·cb_hi) or in ``"split3"`` (xh·cb_hi + xh·cb_lo + xl·cb_hi,
where cb_hi = bf16(cb), cb_lo = bf16(cb − cb_hi) and likewise xh, xl), with
the ‖e‖² of the codebook that is dotted. Its ``quant_mode`` gives q = cb[idx]
(``"f32"``) or float(cb_hi[idx]) + float(cb_lo[idx]) (``"split2"``). The
gradient's ``mode`` is the segment sum of g (``"f32"``), or the segment sum of
bf16(g) plus that of bf16(g − bf16(g)) (``"split2"``).

On CUDA tensors the f32 modes launch the fused VQ's kernels (``vq_fused_fwd``,
``vq_codebook_grad``), whose functions they are, and the other modes
``csrc/vq_precision.cu``, with the bf16 dots on the tensor cores (``wgmma``
with the codebook in shared memory, ``fwd_smem_bytes``). On CPU
tensors each runs its plain version. The forward keeps the JAX function's
output shapes without its row padding: q (N, D), idx (N, 1) int32,
counts (1, K), sq (1, 1).
"""
from __future__ import annotations

import collections

import torch

from msla_tpu_torch.ops import segment_sum
from msla_tpu_torch.ops._build import (SMEM_BYTES, check, count_launch, kernel, require,
                                       runs_plain, stream_of)
from msla_tpu_torch.ops.nearest_codes import _REF_ROWS, D, code_norms
from msla_tpu_torch.ops._build import aligned
from msla_tpu_torch.ops.vq_fused import (count_outputs, vq_codebook_grad,
                                         vq_codebook_grad_ref, vq_fused_fwd)

DIST_MODES = ("f32", "bf16", "split3")
QUANT_MODES = ("f32", "split2")
GRAD_MODES = ("f32", "split2")
#: the (dist_mode, quant_mode) pairs csrc/vq_precision.cu is compiled for: the
#: ones the measurement tool runs besides f32/f32; values are its mode codes
COMPILED = {("bf16", "split2"): (0, 1), ("bf16", "f32"): (0, 0), ("split3", "split2"): (1, 1)}
_BN = 256                       # the forward's codes a product tile: K is padded to a multiple
_X_TILES = 2 * 8 * 16 * D * 4   # the forward's x tiles: two of 16 fp32 rows for each of 8 warps


def check_modes(dist_mode: str, quant_mode: str) -> None:
    if dist_mode not in DIST_MODES or quant_mode not in QUANT_MODES:
        raise ValueError(f"vq_precision_fwd: dist_mode must be one of {DIST_MODES} and "
                         f"quant_mode one of {QUANT_MODES}, got {dist_mode!r}, {quant_mode!r}")


def check_grad_mode(mode: str) -> None:
    if mode not in GRAD_MODES:
        raise ValueError(f"vq_precision_bwd: mode must be one of {GRAD_MODES}, got {mode!r}")


def fwd_smem_bytes(k: int, dist_mode: str, quant_mode: str) -> int:
    """Shared memory of the forward kernel (``fwd_smem_bytes`` in
    ``csrc/vq_precision.cu``, with ``flush_block``'s 64 static bytes): cb_hi,
    and cb_lo where split3's products or split2's q read it, as bf16 rows
    padded to a multiple of 256 codes; 8 warps' two x tiles; −‖e‖²/2 and the
    histogram; 1 KB of alignment."""
    kpad = -(-k // _BN) * _BN
    arrays = 2 if dist_mode == "split3" or quant_mode == "split2" else 1
    return kpad * (arrays * D * 2 + 8) + _X_TILES + 1024 + 64


def check_codes(k: int, dist_mode: str, quant_mode: str) -> None:
    """The forward kernel's K: a multiple of 64 whose shared memory fits,
    up to 512 with cb_lo (split3, split2) and 1,024 without (bf16/f32)."""
    if k % 64 or fwd_smem_bytes(k, dist_mode, quant_mode) > SMEM_BYTES:
        raise ValueError(f"vq_precision_fwd: the kernel takes a multiple of 64 codes whose "
                         f"bf16 codebook fits in shared memory, got K={k} for "
                         f"{dist_mode}/{quant_mode}")


def bwd_smem_bytes(k: int) -> int:
    """Shared memory of the split2 gradient kernel at K codes
    (``csrc/segment_sum.cuh``): the (K + 1, 64) fp32 accumulator (the hi and
    lo sums of the block's 32 columns) and three TMA stages of 128 rows; K up
    to 689 fits."""
    return segment_sum.smem_bytes(k, split2=True)


def split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) in bf16: hi = bf16(t), lo = bf16(t − hi), each rounded to nearest even."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def dotted_norms(hi: torch.Tensor, lo: torch.Tensor, dist_mode: str) -> torch.Tensor:
    """‖e‖² of the codebook a bf16 mode dots: cb_hi (bf16) or cb_hi + cb_lo (split3)."""
    return code_norms(hi.float() if dist_mode == "bf16" else hi.float() + lo.float())


def _dots(x: torch.Tensor, codebook: torch.Tensor, dist_mode: str) -> torch.Tensor:
    """x·eᵀ in the mode's precision: bf16 operands, products exact in fp32."""
    if dist_mode == "f32":
        return x @ codebook.T
    xh, xl = (t.float() for t in split_bf16(x))
    hi, lo = (t.float() for t in split_bf16(codebook))
    dots = xh @ hi.T
    if dist_mode == "split3":
        dots = dots + xh @ lo.T + xl @ hi.T
    return dots


def vq_precision_fwd_ref(flat_x: torch.Tensor, codebook: torch.Tensor, dist_mode: str,
                         quant_mode: str):
    """Plain version: the mode's distances in row chunks, first argmin,
    ``index_select`` of the mode's codebook, ``bincount``, Σ(q − x)²."""
    check_modes(dist_mode, quant_mode)
    e2 = (code_norms(codebook) if dist_mode == "f32"
          else dotted_norms(*split_bf16(codebook), dist_mode))
    idx = torch.cat([torch.argmin(e2 - 2.0 * _dots(chunk, codebook, dist_mode), dim=1)
                     for chunk in flat_x.split(_REF_ROWS)]).to(torch.int32)
    if quant_mode == "split2":
        hi, lo = split_bf16(codebook)
        codebook = hi.float() + lo.float()
    q = codebook.index_select(0, idx)
    counts = torch.bincount(idx, minlength=codebook.shape[0]).to(torch.float32)
    return q, idx[:, None], counts[None], ((q - flat_x) ** 2).sum().reshape(1, 1)


def vq_precision_fwd(flat_x: torch.Tensor, codebook: torch.Tensor, dist_mode: str,
                     quant_mode: str):
    """(N, D) × (K, D) fp32 → q (N, D) fp32, idx (N, 1) int32, counts (1, K)
    fp32 and sq (1, 1) fp32 = Σ‖q − x‖², in the given precision modes."""
    check_modes(dist_mode, quant_mode)
    if (dist_mode, quant_mode) == ("f32", "f32"):  # make_fwd's f32 branches: #4's function
        q, idx, counts, sq = vq_fused_fwd(flat_x, codebook)
        return q, idx[:, None], counts[None], sq.reshape(1, 1)
    if runs_plain("vq_precision_fwd", flat_x, codebook):
        return vq_precision_fwd_ref(flat_x, codebook, dist_mode, quant_mode)

    if (dist_mode, quant_mode) not in COMPILED:
        raise ValueError(f"vq_precision_fwd: the kernel is compiled for {sorted(COMPILED)} "
                         f"and f32/f32, got {dist_mode}/{quant_mode}")
    n, k = flat_x.shape[0], codebook.shape[0]
    require("vq_precision_fwd", flat_x, "flat_x", (n, D))
    require("vq_precision_fwd", codebook, "codebook", (k, D))
    check_codes(k, dist_mode, quant_mode)
    dev = flat_x.device
    hi, lo = split_bf16(codebook)
    e2 = dotted_norms(hi, lo, dist_mode)
    q = torch.empty((n, D), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    counts, sq, counts_i, sq_part, parts = count_outputs(k, dev)
    check("vq_precision_fwd", kernel("vq_precision_fwd")(
        *COMPILED[dist_mode, quant_mode], flat_x.data_ptr(), codebook.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), e2.data_ptr(), q.data_ptr(), idx.data_ptr(),
        counts.data_ptr(), sq.data_ptr(), counts_i.data_ptr(), sq_part.data_ptr(), parts, n,
        k, stream_of(flat_x)))
    count_launch(vq_precision_fwd, f"{dist_mode}/{quant_mode}")
    return q, idx[:, None], counts[None], sq.reshape(1, 1)


def vq_precision_bwd_ref(g: torch.Tensor, idx: torch.Tensor, mode: str,
                         k: int = 512) -> torch.Tensor:
    """Plain version: one ``index_add_`` (f32), or one for each bf16 part of g,
    the two sums added (split2)."""
    check_grad_mode(mode)
    if mode == "f32":
        return vq_codebook_grad_ref(g, idx, k)
    hi, lo = split_bf16(g)
    return vq_codebook_grad_ref(hi.float(), idx, k) + vq_codebook_grad_ref(lo.float(), idx, k)


def vq_precision_bwd(g: torch.Tensor, idx: torch.Tensor, mode: str,
                     k: int = 512) -> torch.Tensor:
    """(N, D) fp32 gradients and (N,) int32 ids → (K, D) fp32 per-code sums in
    the given mode."""
    check_grad_mode(mode)
    if mode == "f32":  # make_bwd("f32"): #5's function
        return vq_codebook_grad(g, idx, k)
    if runs_plain("vq_precision_bwd", g, idx):
        return vq_precision_bwd_ref(g, idx, mode, k)

    n = g.shape[0]
    require("vq_precision_bwd", g, "g", (n, D))
    require("vq_precision_bwd", idx, "idx", (n,), torch.int32)
    if k < 1 or bwd_smem_bytes(k) > SMEM_BYTES:
        raise ValueError(f"vq_precision_bwd: K={k} codes do not fit in shared memory "
                         f"(bwd_smem_bytes)")
    dev = g.device
    g, idx = aligned(g), aligned(idx)
    clusters, rows = segment_sum.launch_layout("vq_precision_bwd_split2", n, k, dev, split2=True)
    dcb = torch.empty((k, D), dtype=torch.float32, device=dev)
    partials = torch.empty((clusters, 2, k, D), dtype=torch.float32, device=dev)  # scratch
    check("vq_precision_bwd", kernel("vq_precision_bwd_split2")(
        g.data_ptr(), idx.data_ptr(), dcb.data_ptr(), partials.data_ptr(), clusters, rows, n,
        k, stream_of(g)))
    count_launch(vq_precision_bwd, torch.float32)
    return dcb


vq_precision_fwd.launches = collections.Counter()  # keyed by "dist/quant" mode
vq_precision_bwd.launches = collections.Counter()
