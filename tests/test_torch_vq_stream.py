"""The streamed VQ search of K3 and #4 at D = 128 and 256 (``csrc/vq_stream.cuh``:
a TMA ring of stages, the codebook split once a block tile), on the CPU:

* ``search_smem_bytes`` restates the ring's shared memory from the header's
  constants at every (K, D) the sweep samples, with and without #4's
  histogram, and at the largest K #4 takes, the next even K refused;
* K3 takes any even K at the streamed widths (no codebook and no ‖e‖² in
  shared memory), and every K the first streamed design (two 32-code
  stages, ‖e‖² and the x tiles in shared memory) admitted is still admitted;
* ``tools/bench_stems.py`` times the streamed kernels at ``chip_smoke.py``
  phase 26's shapes.

The ring keeps the k8 steps of ``csrc/vq_search.cuh`` in their order (a
stage is one pair of steps, the pairs in ascending depth), so its ids are the
first design's, and ``nearest_codes_3xtf32_ref`` stays their emulation
(``tests/test_torch_widths.py``, ``tests/test_torch_vq_search_3xtf32.py``).
"""
import importlib.util
import re
from pathlib import Path

import pytest
import yaml

from msla_tpu_torch.ops._build import CSRC, SMEM_BYTES
from msla_tpu_torch.ops.nearest_codes import (_RING, _SLICE, _STAGE_CODES, _TILE_ROWS, WIDTHS,
                                              plan_search, search_smem_bytes, tuned_takes)

REPO = Path(__file__).resolve().parents[1]
STREAMED = [d for d in WIDTHS if d > 64]
SPACE = yaml.safe_load((REPO / "configs/hparams_search/optuna.yaml").read_text())[
    "hydra"]["sweeper"]["params"]


def _choices(name: str) -> list[int]:
    spec = SPACE[f"model.vqvae.{name}"]
    return [int(v) for v in spec[spec.index("(") + 1:spec.index(")")].split(",")]


def _header(name: str) -> int:
    """A ``constexpr int`` of csrc/vq_stream.cuh."""
    found = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / "vq_stream.cuh").read_text())
    assert len(found) == 1, name
    return int(found[0])


def _largest_with_hist(d: int) -> int:
    k = 2
    while search_smem_bytes(k + 2, True, d) <= SMEM_BYTES:
        k += 2
    return k


def test_the_ring_constants_are_the_headers():
    assert (_header("DS"), _header("STAGES")) == (_SLICE, _RING)
    assert _header("PRODUCERS") == 4  # a warpgroup: its registers go to the consumers
    slabs, consumers, nt = _header("SLABS"), _header("CONSUMERS"), _header("NT")
    assert (32 * slabs, 8 * nt * (consumers // slabs)) == (_TILE_ROWS, _STAGE_CODES)
    assert (slabs, consumers, nt) == (4, 8, 8)  # 2 warps a slab, 64 codes a warp


@pytest.mark.parametrize("d", STREAMED)
def test_search_smem_follows_the_ring_layout(d):
    """128 bytes to align; x: D / 16 slices of the block tile's rows; 4
    stages of a hi and a lo plane of 16 columns; the (dist, index) merge of a
    slab's two warps; 3 mbarriers a stage and one an x slice;
    then #4's histogram (4 B a code) and its 8 consumer warps' fp64 partials."""
    slices = d // _SLICE
    fixed = (128 + slices * _TILE_ROWS * _SLICE * 4 + _RING * 2 * _STAGE_CODES * _SLICE * 4
             + 8 * 32 * 8 + (3 * _RING + slices) * 8)
    assert fixed == {128: 133_408, 256: 199_008}[d]
    assert _TILE_ROWS * d * 4 == {128: 64, 256: 128}[d] * 1024     # the block tile's x
    for k in _choices("num_embedding"):
        assert search_smem_bytes(k, False, d) == fixed
        assert search_smem_bytes(k, True, d) == fixed + 4 * k + 8 * 8
        for with_hist in (False, True):
            assert tuned_takes(k, d, with_hist)
            assert plan_search(k, d, with_hist).design == "ring"


@pytest.mark.parametrize("d", STREAMED)
def test_the_largest_k_with_the_histogram_and_the_next_refused(d):
    """The ring refuses the next K (its histogram would pass shared memory),
    which then runs on the any-width kernel."""
    largest = _largest_with_hist(d)
    assert largest == {128: 24_744, 256: 8_344}[d]
    assert tuned_takes(largest, d, True)
    assert plan_search(largest, d, True).design == "ring"
    assert not tuned_takes(largest + 2, d, True)
    assert plan_search(largest + 2, d, True).design == "any width"


@pytest.mark.parametrize("d", STREAMED)
def test_k3_takes_any_even_k_at_the_streamed_widths(d):
    """The ring takes any even K, past the any-width kernel's MAX_K too; an
    odd K runs on the any-width kernel, and K = 0 is refused."""
    for k in (2, 4_448, 24_746, 100_000):
        assert tuned_takes(k, d, False)
        assert plan_search(k, d).design == "ring"
    for k in (1, 513):
        assert not tuned_takes(k, d, False)
        assert plan_search(k, d).design == "any width"
    assert not tuned_takes(0, d, False)
    with pytest.raises(ValueError, match="K=0"):
        plan_search(0, d)


@pytest.mark.parametrize("d", STREAMED)
def test_every_k_the_first_streamed_design_admitted_is_still_admitted(d):
    """The first design held two 32-code stages, ‖e‖² (and #4's histogram)
    padded to 32 codes, and 8 (D = 128) or 4 (D = 256) warps' 32-row x tiles."""
    warps = 8 if d <= 128 else 4

    def first_design(k, with_hist):
        kpad = -(-k // 32) * 32
        return 4 * (2 * 32 * d + kpad * (1 + with_hist) + warps * 32 * d) + 64 * with_hist

    for with_hist in (False, True):
        admitted = [k for k in range(2, 20_000, 2) if first_design(k, with_hist) <= SMEM_BYTES]
        assert admitted[-1] == {(128, False): 17_152, (128, True): 8_544,
                                (256, False): 8_960, (256, True): 4_448}[d, with_hist]
        for k in admitted:
            assert search_smem_bytes(k, with_hist, d) <= SMEM_BYTES


def test_bench_stems_times_the_streamed_kernels_at_phase_26s_shapes():
    from msla_tpu_torch.tools import bench_stems

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert bench_stems.SWEEP_N == cs.SWEEP_BATCH * cs.FRAME // 4 == 352_000
    assert sorted(bench_stems.STREAMED) == sorted(
        (d, k) for k in _choices("num_embedding") for d in _choices("embedding_dim") if d > 64)
    assert bench_stems.build_sources("kernel", ("nearest_codes", "vq_fused")) == (
        "nearest_codes", "vq_fused")
    assert bench_stems.build_sources("A streamed", ("nearest_codes",)) == ("nearest_codes",)
