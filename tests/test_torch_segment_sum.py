"""The codebook gradient's segment sum in the order its CUDA kernels take it
(csrc/segment_sum.cuh: #5 vq_codebook_grad and #9's split2 vq_precision_bwd),
on the CPU.

ops/segment_sum.py codebook_grad_order_ref is held bit for bit against the
order written out as a plain loop over the rows (small N, several grids), then
against the JAX package's Pallas kernel (vq_codebook_grad_pallas in interpret
mode, as tests/test_torch_vq_fused.py runs it) and, in split2, against the
JAX tool's make_bwd("split2") (tools/bench_vq_precision.py, K = 512, as
tests/test_torch_vq_precision.py runs it), at rtol 1e-5 with an atol for
each entry of 1e-5·Σ|g| over that code's rows, which a row dropped or
doubled exceeds (checked): on uniform ids, one code for every row, long sorted runs, codes
left empty (and ids outside [0, K)), at N no multiple of 32 or of a part's
rows. Then segment_sum_bound (the summation depth × 2⁻²⁴ × Σ|g|, which
chip_smoke.py holds the kernels to against fp64) holds the order and the
plain index_add_ and rejects a sum taken in bf16; the launch layout covers
every row; and the K limits follow from grad_smem_bytes and bwd_smem_bytes
and the header's constants.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from msla_tpu.ops import vq_fused as jax_vq_fused
from msla_tpu_torch.ops import segment_sum
from msla_tpu_torch.ops._build import CSRC, SMEM_BYTES
from msla_tpu_torch.ops.segment_sum import (codebook_grad_order_ref, layout, segment_sum_bound,
                                            segment_sum_fp64, split_terms, summation_depth)
from msla_tpu_torch.ops.vq_fused import grad_smem_bytes
from msla_tpu_torch.ops.vq_precision import bwd_smem_bytes
from tools import bench_vq_precision as jax_tool

jax_vq_fused.INTERPRET = True

KINDS = ("uniform", "one code", "sorted runs", "empty codes", "out of range")


def ids_of(kind: str, n: int, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        ids = rng.integers(0, k, n)
    elif kind == "one code":
        ids = np.full(n, k // 3)
    elif kind == "sorted runs":  # 12 codes, each in one run of some hundreds of rows
        ids = np.sort(rng.choice(k, 12, replace=False)[rng.integers(0, 12, n)])
    elif kind == "empty codes":  # every third code below K/2, the rest never used
        ids = rng.integers(0, k // 6, n) * 3
    else:  # a few ids outside [0, K) among uniform ones: they add nothing
        ids = rng.integers(0, k, n)
        ids[rng.integers(0, n, max(1, n // 50))] = k
        ids[rng.integers(0, n, max(1, n // 50))] = -1
    return ids.astype(np.int32)


def inputs(kind: str, n: int, k: int, seed: int = 0):
    g = np.random.default_rng(seed + 1).standard_normal((n, 64)).astype(np.float32)
    return torch.from_numpy(g), torch.from_numpy(ids_of(kind, n, k, seed))


def loop_order(g: torch.Tensor, idx: torch.Tensor, k: int, blocks: int,
               split2: bool) -> np.ndarray:
    """The kernels' order written out row by row: per part, per 32-row group,
    each code's rows left to right, the group's sums into the part's
    accumulator, parts in cluster order, clusters in order (split2: hi, lo
    apart, then added)."""
    halves = 2 if split2 else 1
    parts, per = blocks // halves, 4 // halves
    n = g.shape[0]
    rows = segment_sum.rows_per_part(n, parts, split2)
    ids = idx.numpy()
    totals = []
    for x in (split_terms(g) if split2 else (g,)):
        x = x.numpy()
        accs = []
        for part in range(parts):
            acc = np.zeros((k, 64), np.float32)
            stop = min(n, (part + 1) * rows)
            for r0 in range(part * rows, stop, 32):
                seg = {}
                for r in range(r0, min(r0 + 32, stop)):
                    c = int(ids[r])
                    if 0 <= c < k:
                        seg[c] = x[r] if c not in seg else seg[c] + x[r]
                for c, s in seg.items():
                    acc[c] = acc[c] + s
            accs.append(acc)
        clusters = []
        for c in range(parts // per):
            s = accs[c * per]
            for t in range(1, per):
                s = s + accs[c * per + t]
            clusters.append(s)
        total = clusters[0]
        for s in clusters[1:]:
            total = total + s
        totals.append(total)
    return totals[0] if not split2 else totals[0] + totals[1]


@pytest.mark.parametrize("split2", [False, True], ids=["#5", "split2"])
@pytest.mark.parametrize("n,blocks", [(300, 4), (777, 8), (1, 4), (65, 12)])
@pytest.mark.parametrize("kind", KINDS)
def test_order_ref_is_the_order_bit_for_bit(kind, n, blocks, split2):
    g, idx = inputs(kind, n, 24, seed=n)
    got = codebook_grad_order_ref(g, idx, 24, blocks, split2=split2)
    assert got.dtype == torch.float32 and got.shape == (24, 64)
    np.testing.assert_array_equal(got.numpy(), loop_order(g, idx, 24, blocks, split2))


def _close_to(got: torch.Tensor, want: np.ndarray, g: torch.Tensor, idx: torch.Tensor) -> None:
    """|got − want| ≤ 1e-5·|want| + 1e-5·Σ|g| over the entry's code's rows."""
    k = got.shape[0]
    keep = (idx >= 0) & (idx < k)
    mass = torch.zeros((k, 64), dtype=torch.float64).index_add_(
        0, idx[keep].long(), g[keep].abs().double()).numpy()
    err = np.abs(got.numpy().astype(np.float64) - want)
    beyond = err > 1e-5 * np.abs(want) + 1e-5 * mass
    assert not beyond.any(), (f"{beyond.sum()} of {beyond.size} sums beyond the tolerance; "
                              f"largest error {err.max():.3e}")


@pytest.mark.parametrize("n", [4095, 1000])
@pytest.mark.parametrize("kind", KINDS)
def test_order_ref_matches_the_pallas_kernel(kind, n):
    """K = 512; 8 blocks (two clusters of 4 parts), so N = 4,095 leaves the
    last part short and no count is a multiple of 32."""
    g, idx = inputs(kind, n, 512, seed=7)
    want = np.asarray(jax_vq_fused.vq_codebook_grad_pallas(
        jnp.asarray(g.numpy()), jnp.asarray(idx.numpy()), 512, tile=2048))
    _close_to(codebook_grad_order_ref(g, idx, 512, 8), want, g, idx)


@pytest.mark.parametrize("n", [4095, 1000])
@pytest.mark.parametrize("kind", KINDS)
def test_split2_order_ref_matches_the_jax_tool(kind, n):
    g, idx = inputs(kind, n, 512, seed=11)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tool.make_bwd("split2")(jnp.asarray(g.numpy()),
                                                      jnp.asarray(idx.numpy())))
    _close_to(codebook_grad_order_ref(g, idx, 512, 8, split2=True), want, g, idx)


@pytest.mark.parametrize("split2", [False, True], ids=["#5", "split2"])
@pytest.mark.parametrize("kind", ("uniform", "one code"))
def test_tolerance_rejects_a_dropped_row(kind, split2):
    """The JAX package's sums against the order with row 500 left out: the
    tolerance above tells them apart."""
    g, idx = inputs(kind, 1000, 512, seed=13)
    if split2:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_tool.make_bwd("split2")(jnp.asarray(g.numpy()),
                                                          jnp.asarray(idx.numpy())))
    else:
        want = np.asarray(jax_vq_fused.vq_codebook_grad_pallas(
            jnp.asarray(g.numpy()), jnp.asarray(idx.numpy()), 512, tile=2048))
    dropped = idx.clone()
    dropped[500] = -1
    with pytest.raises(AssertionError):
        _close_to(codebook_grad_order_ref(g, dropped, 512, 8, split2=split2), want, g, idx)


@pytest.mark.parametrize("split2", [False, True], ids=["#5", "split2"])
@pytest.mark.parametrize("kind", ("uniform", "one code", "sorted runs"))
def test_bound_holds_the_order_and_the_plain_sum(kind, split2):
    n, k, blocks = 4095, 512, 8
    g, idx = inputs(kind, n, k, seed=3)
    want = segment_sum_fp64(g, idx, k, split2)
    bound = segment_sum_bound(g, idx, k, summation_depth(n, blocks, split2), split2)
    terms = split_terms(g) if split2 else (g,)
    plain = sum(torch.zeros((k, 64)).index_add_(0, idx.long(), t) for t in terms)
    for got in (codebook_grad_order_ref(g, idx, k, blocks, split2=split2), plain):
        assert ((got.double() - want).abs() <= bound).all()


@pytest.mark.parametrize("kind", ("uniform", "one code"))
def test_bound_rejects_a_sum_in_bf16(kind):
    n, k, blocks = 4095, 512, 8
    g, idx = inputs(kind, n, k, seed=5)
    in_bf16 = torch.zeros((k, 64), dtype=torch.bfloat16).index_add_(
        0, idx.long(), g.to(torch.bfloat16))
    bound = segment_sum_bound(g, idx, k, summation_depth(n, blocks))
    assert ((in_bf16.double() - segment_sum_fp64(g, idx, k)).abs() > bound).any()


def test_summation_depth_counts_the_orders_levels():
    """704,000 rows on 32 clusters: 5,504-row parts of 172 groups (#5), 11,008
    rows of 344 groups (split2, two parts a cluster)."""
    assert summation_depth(704_000, 128) == 31 + 172 + 3 + 31
    assert summation_depth(704_000, 128, split2=True) == 31 + 344 + 1 + 31 + 1


@pytest.mark.parametrize("split2", [False, True], ids=["#5", "split2"])
@pytest.mark.parametrize("n", [1, 31, 33, 4097, 704_001])
@pytest.mark.parametrize("max_clusters", [1, 32, 33])
def test_layout_covers_every_row_in_whole_stages(n, max_clusters, split2):
    clusters, rows = layout(n, max_clusters, split2)
    parts = clusters * 4 // (2 if split2 else 1)
    assert 1 <= clusters <= max_clusters
    assert rows % segment_sum.STAGE_ROWS[split2] == 0 and parts * rows >= n
    assert (clusters - 1) * (parts // clusters) * rows < n  # no cluster without rows


def _header_constants(name: str) -> list[int]:
    text = (CSRC / "segment_sum.cuh").read_text()
    return [int(v) for v in re.findall(rf"\b{name} = (\d+)", text)]


def test_k_limits_follow_from_the_shared_memory():
    """#5 keeps K ≤ 640 (K3's search limit) and split2 K ≤ 512; the Python
    figures are the header's (its constants and the stage bytes it pins with
    a static_assert on Layout::STAGE_BYTES)."""
    text = (CSRC / "segment_sum.cuh").read_text()
    for split2 in (False, True):
        pinned = re.findall(rf"Layout<{str(split2).lower()}>::STAGE_BYTES == (\d+)", text)
        assert [int(v) for v in pinned] == [segment_sum._stage_bytes(split2)]
    assert _header_constants("CLUSTER") == [segment_sum.CLUSTER]
    assert _header_constants("MIN_STAGES") == [segment_sum.MIN_STAGES]
    assert _header_constants("TURNS") == [segment_sum.TURNS]
    assert _header_constants("SMEM_LIMIT") == [SMEM_BYTES]
    assert _header_constants("STAGE_ROWS") == [segment_sum.STAGE_ROWS[False],
                                               segment_sum.STAGE_ROWS[True]]
    for fn, most in ((grad_smem_bytes, 701), (bwd_smem_bytes, 689)):
        assert fn(most) <= SMEM_BYTES < fn(most + 1)
        assert fn(most) - fn(most - 1) == 64 * 4  # a code's fp32 row of the accumulator
    assert grad_smem_bytes(640) <= SMEM_BYTES and bwd_smem_bytes(512) <= SMEM_BYTES
