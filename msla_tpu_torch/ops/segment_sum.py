"""The codebook gradient's segment sum as its CUDA kernels take it
(``csrc/segment_sum.cuh``, shared by #5 ``vq_codebook_grad`` and #9's split2
``vq_precision_bwd``): the shared memory a K needs, the launch's layout, the
summation order the kernels follow, on the plain ops
(``codebook_grad_order_ref``), and the bound of that order's error against
fp64 (``segment_sum_bound``).

The order: the rows are cut into ``parts`` contiguous runs of
``rows_per_part`` rows (a multiple of the stage's rows), and each part into
32-row groups. In a group, each code's rows are summed left to right in
ascending row order; each group's sums are added into its part's (K, 64)
accumulator in group order; a cluster's parts are summed in part order and
the clusters in cluster order. Split2 takes the sum of bf16(g) and the sum of
bf16(g − bf16(g)) (round to nearest even) apart that way and adds them at the
end. Ids outside [0, K) add nothing. Rows wider than 64 (#5 at D = 128 and
256) run as D / 64 column slices of 64, each on its share of the clusters
that run at once and in this order; a column's sum reads no other column, so
the order holds for every column at the slice's grid.
"""
from __future__ import annotations

import ctypes
import functools

import torch

CLUSTER = 4                           # blocks a cluster
SLICE = 64                            # columns a block's accumulator holds
MIN_STAGES = 3                        # TMA stages a block needs at the least
STAGE_ROWS = {False: 64, True: 128}   # rows a stage, by split2
HALVES = {False: 1, True: 2}          # blocks that share a part, one a column half
TURNS = 8                             # the consumers' turn mbarriers
_ACC_BYTES = 64 * 4                   # a code's row of a block's accumulator
_U = 2.0 ** -24                       # fp32's unit roundoff


def _stage_bytes(split2: bool) -> int:
    """A stage of ``csrc/segment_sum.cuh`` (``Layout::STAGE_BYTES``): its rows
    of the block's columns, their ids, a (row, code) offset pair and an end
    weight a row, a starts mask a 32-row group, three mbarriers."""
    rows, groups = STAGE_ROWS[split2], STAGE_ROWS[split2] // 32
    return rows * (64 // HALVES[split2]) * 4 + rows * 4 + groups * (32 * 12 + 4) + 3 * 8


def smem_bytes(k: int, split2: bool) -> int:
    """Dynamic shared memory of the kernel at K codes and its fewest stages:
    the (K + 1, 64) fp32 accumulator (a spare row takes the adds of ids outside
    [0, K)), MIN_STAGES stages, TURNS mbarriers and 128 bytes to align."""
    return (k + 1) * _ACC_BYTES + MIN_STAGES * _stage_bytes(split2) + TURNS * 8 + 128


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def rows_per_part(n: int, parts: int, split2: bool) -> int:
    """The rows of each part: ⌈N / parts⌉ rounded up to whole stages."""
    stage = STAGE_ROWS[split2]
    return _ceil_div(_ceil_div(n, parts), stage) * stage


def layout(n: int, max_clusters: int, split2: bool) -> tuple[int, int]:
    """(clusters, rows_per_part) of a launch over N rows: as many clusters as
    run at once, or fewer where the rows make fewer than one stage a part."""
    per = CLUSTER // HALVES[split2]
    stages = max(1, _ceil_div(n, STAGE_ROWS[split2]))
    clusters = max(1, min(max_clusters, _ceil_div(stages, per)))
    return clusters, rows_per_part(n, clusters * per, split2)


@functools.lru_cache(maxsize=None)
def _max_clusters(symbol: str, k: int, device_index: int) -> int:
    from msla_tpu_torch.ops._build import check, kernel

    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(symbol, kernel(f"{symbol}_clusters")(k, ctypes.addressof(out)))
    if out.value < 1:
        raise RuntimeError(f"{symbol}: no cluster of {CLUSTER} blocks fits on the card at K={k}")
    return out.value


def launch_layout(symbol: str, n: int, k: int, device: torch.device,
                  split2: bool, slices: int = 1) -> tuple[int, int]:
    """(clusters, rows_per_part) of each column slice of the kernel behind
    ``symbol`` on ``device``: the clusters the card runs at once (asked of
    CUDA once), shared by the ``slices`` slices."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return layout(n, max(1, _max_clusters(symbol, k, index) // slices), split2)


def split_terms(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split2's terms of g in fp32: bf16(g) and bf16(g − bf16(g))."""
    from msla_tpu_torch.ops.vq_precision import split_bf16  # it imports this module

    return tuple(t.float() for t in split_bf16(g))


def _order_sum(x: torch.Tensor, idx: torch.Tensor, k: int, parts: int, per: int,
               split2: bool) -> torch.Tensor:
    n, d = x.shape
    rows = rows_per_part(n, parts, split2)
    groups = rows // 32
    codes = idx.long()
    codes = torch.where((codes >= 0) & (codes < k), codes, k)  # k: adds nothing
    xp = x.new_zeros((parts * rows, d))
    xp[:n] = x
    cp = codes.new_full((parts * rows,), k)
    cp[:n] = codes
    cg = cp.view(parts, groups, 32)
    order = (cg * 32 + torch.arange(32, device=x.device)).argsort(dim=-1)
    cs = cg.gather(-1, order)
    xs = xp.view(parts, groups, 32, d).gather(2, order[..., None].expand(-1, -1, -1, d))
    start = torch.ones_like(cs, dtype=torch.bool)
    start[..., 1:] = cs[..., 1:] != cs[..., :-1]
    end = torch.ones_like(cs, dtype=torch.bool)
    end[..., :-1] = cs[..., :-1] != cs[..., 1:]
    end &= cs < k
    run = torch.empty_like(xs)  # each sorted position's running sum in its segment
    r = run[:, :, 0] = xs[:, :, 0]
    for p in range(1, 32):
        r = run[:, :, p] = torch.where(start[:, :, p, None], xs[:, :, p], r + xs[:, :, p])
    acc = x.new_zeros((parts, k, d))
    for j in range(groups):  # a group's ends hold distinct codes of its part
        b, p = end[:, j].nonzero(as_tuple=True)
        c = cs[b, j, p]
        acc[b, c] = acc[b, c] + run[b, j, p]
    acc = acc.view(parts // per, per, k, d)
    clusters = acc[:, 0]
    for t in range(1, per):
        clusters = clusters + acc[:, t]
    out = clusters[0]
    for c in range(1, clusters.shape[0]):
        out = out + clusters[c]
    return out


def codebook_grad_order_ref(g: torch.Tensor, idx: torch.Tensor, k: int, blocks: int,
                            split2: bool = False) -> torch.Tensor:
    """(N, D) fp32 g and (N,) ids → (K, D) fp32 per-code sums, taken in the
    order the kernels of a ``blocks``-block launch take them (the module's
    docstring), on the plain ops: equal to the kernels' results bit for bit.
    ``split2`` sums bf16(g) and bf16(g − bf16(g)) apart and adds the two."""
    halves = HALVES[split2]
    if blocks % CLUSTER:
        raise ValueError(f"codebook_grad_order_ref: {blocks} blocks in clusters of {CLUSTER}")
    if g.shape[0] == 0:
        return g.new_zeros((k, g.shape[1]))
    args = (idx, k, blocks // halves, CLUSTER // halves, split2)
    if not split2:
        return _order_sum(g, *args)
    hi, lo = split_terms(g)
    return _order_sum(hi, *args) + _order_sum(lo, *args)


def summation_depth(n: int, blocks: int, split2: bool = False) -> int:
    """The most roundings an addend meets in a ``blocks``-block launch's order:
    31 in its group, one a group of its part, one a part of its cluster and
    one a cluster after it, and split2's last add."""
    halves = HALVES[split2]
    parts, per = blocks // halves, CLUSTER // halves
    groups = rows_per_part(n, parts, split2) // 32
    return 31 + groups + (per - 1) + (parts // per - 1) + int(split2)


def segment_sum_fp64(g: torch.Tensor, idx: torch.Tensor, k: int,
                     split2: bool = False) -> torch.Tensor:
    """The function in fp64: Σ g (or Σ bf16 parts of g) over each code's rows."""
    x = g.double() if not split2 else sum(t.double() for t in split_terms(g))
    keep = (idx >= 0) & (idx < k)
    return x.new_zeros((k, g.shape[1])).index_add_(0, idx[keep].long(), x[keep])


def segment_sum_bound(g: torch.Tensor, idx: torch.Tensor, k: int, depth: int,
                      split2: bool = False) -> torch.Tensor:
    """(K, D) fp64 bound on an fp32 segment sum's distance from fp64: the
    summation depth's γ = depth·u / (1 − depth·u), u = 2⁻²⁴, times Σ |terms|
    over each code's rows (|g|, or |bf16(g)| + |bf16(g − bf16(g))|)."""
    terms = g.abs() if not split2 else sum(t.abs() for t in split_terms(g))
    keep = (idx >= 0) & (idx < k)
    mass = terms.new_zeros((k, g.shape[1]), dtype=torch.float64).index_add_(
        0, idx[keep].long(), terms[keep].double())
    return depth * _U / (1 - depth * _U) * mass
