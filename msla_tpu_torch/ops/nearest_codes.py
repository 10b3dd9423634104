"""Index of the L2-nearest codebook row for each input row.

Port of msla_tpu/ops/vq_pallas.py (``nearest_codes_pallas``). On a CUDA tensor
``nearest_codes`` launches the hand-written kernel ``csrc/nearest_codes.cu``
(3xTF32 on the tensor cores, ``csrc/vq_search.cuh``), which never
materialises the (N, K) distance matrix; on a CPU tensor it runs
``nearest_codes_ref``. Both compute dist = ‖e‖² − 2·x·e (‖x‖² is constant per
row and dropped) and pick the lowest index on ties.
``nearest_codes_3xtf32_ref`` emulates the kernel's products for the tests and
``chip_smoke.py``; no wrapper calls it.

Widths: any D from 1 to ``MAX_D`` and K from 1 to ``MAX_K`` (and K3 any even
K at D = 128 and 256); ``plan_search`` picks the kernel. The tuned kernels take D in ``WIDTHS``, the embedding
widths of configs/hparams_search/optuna.yaml (``tuned_takes``): D = 64 (the
default) with the codebook held in shared memory, an even K up to 640; D =
128 and 256 with the codebook streamed through a ring of stages
(``csrc/vq_stream.cuh``), any even K (#4's forward, whose histogram stays in
shared memory: up to 24,744 and 8,344; ``search_smem_bytes``). Every other
(D, K) runs ``csrc/vq_any.cu``'s kernel, D padded to its k8 step with zero
columns and the last chunk's codes past K at ‖e‖² = +inf. A width past the
limits raises ``ValueError`` naming it on a CUDA tensor; the plain versions
take any.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from msla_tpu_torch.ops._build import (SMEM_BYTES, check, count_launch, kernel, require,
                                       runs_plain, stream_of)
from msla_tpu_torch.ops.tf32 import product_3xtf32

#: the default row width (the model's embedding_dim), whose search holds the codebook
D = 64
#: the row widths the tuned CUDA kernels are compiled for
WIDTHS = (D, 128, 256)
#: the largest row width and codebook any kernel takes
MAX_D, MAX_K = 512, 65_536
#: the any-width search (csrc/vq_any.cu): its k8 step, and (rows a block
#: tile, codes a chunk) by the padded width they fit up to
ANY_GRANULE = 8
ANY_SHAPES = ((128, 128, 64), (256, 64, 64), (512, 32, 32))
_REF_ROWS = 1 << 16    # rows per chunk of the plain version: a 128 MB block at K=512
_REF_BLOCK = 1 << 25   # the most distances a chunk holds (128 MB): fewer rows past K=512
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


def tuned_takes(k: int, d: int, with_hist: bool) -> bool:
    """Whether a tuned search takes K codes of width d: d in ``WIDTHS``, K
    even and within shared memory."""
    return d in WIDTHS and k >= 2 and k % 2 == 0 and \
        search_smem_bytes(k, with_hist, d) <= SMEM_BYTES


def any_smem_bytes(d: int, rows: int, codes: int) -> int:
    """A block of ``csrc/vq_any.cu``'s search, as its ``vq_any_smem_bytes``
    reports it: x's tile [rows][DP + 4], two chunks [2][codes][DP + 4], their
    ‖e‖² [2][codes], the warps' bests [8][16] (dist, index), the tile's ids."""
    ld = -(-d // ANY_GRANULE) * ANY_GRANULE + 4
    return 4 * (rows * ld + 2 * codes * ld + 2 * codes) + 8 * 16 * 8 + 4 * rows


class SearchPlan(NamedTuple):
    """How K3 (or, with the histogram, #4) runs at (K, D): the design
    ("shared", "ring" or "any width"), D and K as the kernel runs them, its
    rows a block tile and codes a chunk (the any-width kernel's), a block's
    shared memory and the share of its products on padded lanes."""
    design: str
    padded: tuple[int, int]
    rows: int
    codes: int
    smem: int
    padded_share: float


def plan_search(k: int, d: int, with_hist: bool = False,
                name: str = "nearest_codes") -> SearchPlan:
    """The search of K codes of width d: the tuned kernel where it takes
    them (``tuned_takes``), else the any-width kernel. Raises ``ValueError``
    past MAX_D, and past MAX_K where no tuned kernel takes K (K3's ring takes
    any even K at D = 128 and 256)."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name}: D={d} outside the kernels' limit, D from 1 to {MAX_D}")
    if not 1 <= k <= MAX_K and not (k > 0 and tuned_takes(k, d, with_hist)):
        raise ValueError(f"{name}: K={k} outside the kernels' limit, K from 1 to {MAX_K}")
    if not tuned_takes(k, d, with_hist):
        dp = -(-d // ANY_GRANULE) * ANY_GRANULE
        _, rows, codes = next(shape for shape in ANY_SHAPES if dp <= shape[0])
        kp = -(-k // ANY_GRANULE) * ANY_GRANULE   # its warps skip n8 tiles past K
        return SearchPlan("any width", (dp, kp), rows, codes, any_smem_bytes(d, rows, codes),
                          1 - d * k / (dp * kp))
    if d == D:
        return SearchPlan("shared", (d, -(-k // _GROUP) * _GROUP), 32, _GROUP,
                          search_smem_bytes(k, with_hist, d), 1 - k / (-(-k // _GROUP) * _GROUP))
    kp = -(-k // _STAGE_CODES) * _STAGE_CODES
    return SearchPlan("ring", (d, kp), _TILE_ROWS, _STAGE_CODES,
                      search_smem_bytes(k, with_hist, d), 1 - k / kp)


def code_norms(codebook: torch.Tensor) -> torch.Tensor:
    """‖e_k‖², shared by the kernel and its plain version."""
    return (codebook * codebook).sum(dim=1)


def _ref_rows(k: int) -> int:
    """Rows a chunk of the plain versions: 65,536, fewer where K codes would
    make the distance block pass 128 MB."""
    return max(1, min(_REF_ROWS, _REF_BLOCK // max(k, 1)))


def nearest_codes_ref(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain version, in row chunks so the distance block stays bounded."""
    e2 = code_norms(codebook)
    out = [torch.argmin(e2 - 2.0 * (chunk @ codebook.T), dim=1)
           for chunk in flat_x.split(_ref_rows(codebook.shape[0]))]
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
           for chunk in flat_x.split(_ref_rows(codebook.shape[0]))]
    return torch.cat(out).to(torch.int32)


def nearest_codes(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, D) fp32 × (K, D) fp32 → (N,) int32 nearest-codebook indices."""
    if runs_plain("nearest_codes", flat_x, codebook):
        return nearest_codes_ref(flat_x, codebook)

    n = flat_x.shape[0]
    k, d = codebook.shape
    plan = plan_search(k, d)
    require("nearest_codes", flat_x, "flat_x", (n, d))
    require("nearest_codes", codebook, "codebook", (k, d))
    e2 = code_norms(codebook)
    idx = torch.empty((n,), dtype=torch.int32, device=flat_x.device)
    x, cb, e2, ids = flat_x.data_ptr(), codebook.data_ptr(), e2.data_ptr(), idx.data_ptr()
    if plan.design == "any width":  # no q: the ids alone
        status = kernel("vq_any_fwd")(x, cb, e2, None, ids, None, None, None, None, 0, n, k, d,
                                      plan.rows, plan.codes, stream_of(flat_x))
    else:
        status = kernel("nearest_codes_fwd")(x, cb, e2, ids, n, k, d, stream_of(flat_x))
    check("nearest_codes", status)
    count_launch(nearest_codes, torch.float32, (d, k))
    return idx


nearest_codes.launches, nearest_codes.widths = collections.Counter(), collections.Counter()
