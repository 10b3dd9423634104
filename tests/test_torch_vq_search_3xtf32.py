"""The VQ search of K3 (nearest_codes) and #4 (vq_fused_fwd) as their kernels
compute it on the tensor cores, in 3xTF32
(msla_tpu_torch.ops.nearest_codes.nearest_codes_3xtf32_ref: every product
split as hi = tf32(v), lo = tf32(v − hi), lo·hi + hi·lo + hi·hi a k8 step),
on the CPU against the JAX package's Pallas kernels in interpret mode on the
same fp32 inputs: ids equal or near-ties (chip_smoke.py's near_ties: fp64
gaps below 1e-5 of |dist| + 1), and #4's q, counts and squared-error sum
from the emulation's ids bit-equal to the fused kernel's where the ids are
(sq at rtol 1e-5). Then chip_smoke.py's planted rows (vq_planted), which it
also holds the card to: exact ties go to the lower index and close pairs 1e-4
apart to the nearer code, in the emulation, the plain version and the JAX
kernel, while one-pass TF32 misses the close pairs. And the shared memory
that bounds the kernels' K."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msla_tpu.ops.vq_fused import vq_fused_fwd_pallas
from msla_tpu.ops.vq_pallas import nearest_codes_pallas
from msla_tpu_torch.ops._build import SMEM_BYTES
from msla_tpu_torch.ops.nearest_codes import (code_norms, nearest_codes_3xtf32_ref,
                                              nearest_codes_ref, search_smem_bytes)
from msla_tpu_torch.ops.tf32 import tf32_round_ref

#: (N, D, K): test_torch_vq.py's shapes, and a few thousand rows at K = 128, 512
SHAPES = [(1000, 64, 512), (7, 64, 512), (64, 8, 16), (3000, 64, 128), (4100, 64, 512)]


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32))


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_emulation_matches_jax_pallas_interpret(n, d, k):
    x, cb = _inputs(n, d, k, seed=n + k)
    want = np.asarray(nearest_codes_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    got = nearest_codes_3xtf32_ref(torch.from_numpy(x), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and got.shape == (n,)
    _chip_smoke().near_ties(torch.from_numpy(x), torch.from_numpy(cb), got,
                            torch.from_numpy(want.copy()))


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_fused_fields_from_the_emulation_match_jax_fused_interpret(n, d, k):
    x, cb = _inputs(n, d, k, seed=2 * n + k)
    q_j, idx_j, counts_j, sq_j = (np.asarray(a) for a in vq_fused_fwd_pallas(
        jnp.asarray(x), jnp.asarray(cb), interpret=True))
    tx, tcb = torch.from_numpy(x), torch.from_numpy(cb)
    idx = nearest_codes_3xtf32_ref(tx, tcb)
    q = tcb.index_select(0, idx.long())
    counts = torch.bincount(idx.long(), minlength=k).float()
    sq = ((q - tx) ** 2).sum()
    mismatches, _, _ = _chip_smoke().near_ties(tx, tcb, idx, torch.from_numpy(idx_j.copy()))
    same = idx.numpy() == idx_j
    np.testing.assert_array_equal(q.numpy()[same], q_j[same])
    if mismatches == 0:
        np.testing.assert_array_equal(counts.numpy(), counts_j)
    else:  # each flip moves one row between two codes
        assert np.abs(counts.numpy() - counts_j).sum() <= 2 * mismatches
    np.testing.assert_allclose(float(sq), float(sq_j), rtol=1e-5)


def _jax_ids(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(nearest_codes_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(e.numpy()), interpret=True)))


def _planted(close):
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(3)
    cb = torch.randn((512, 64), generator=g)
    return cs.vq_planted(cb, close, g)


def test_planted_ties_go_to_the_lower_index():
    """Duplicate codes in one lane, two lanes of a quad (the lower index also
    in the higher lane), two n8 tiles and two groups of the search."""
    x, e, want = _planted(close=False)
    assert torch.equal(e[want], e[torch.tensor([h for _, h in _chip_smoke().VQ_PAIRS])[
        torch.arange(x.shape[0]) % 12]])
    for ids in (nearest_codes_3xtf32_ref(x, e), nearest_codes_ref(x, e),
                _jax_ids(x, e)):
        assert torch.equal(ids.long(), want)


def test_planted_close_pairs_go_to_the_nearer_code_and_one_tf32_pass_misses():
    x, e, want = _planted(close=True)
    one_pass = torch.argmin(code_norms(e) - 2.0 * (tf32_round_ref(x) @ tf32_round_ref(e).T),
                            dim=1)
    for ids in (nearest_codes_3xtf32_ref(x, e), nearest_codes_ref(x, e),
                _jax_ids(x, e)):
        assert torch.equal(ids.long(), want)
    assert (one_pass != want).any()


def test_planted_ties_fail_on_a_construction_that_plants_nothing():
    """vq_planted checks its rows in fp64: codes packed tighter than the rows'
    noise leave the duplicated pair no nearer than the others."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(4)
    cb = torch.randn((512, 64), generator=g) * 0.01
    with pytest.raises(RuntimeError, match="did not plant"):
        cs.vq_planted(cb, False, g)


def test_search_shared_memory_sets_the_k_limits():
    """The codebook, |e|^2 (K padded to a multiple of 32) and 8 warps' 32-row
    x tiles in shared memory: K3 takes K up to 640, #4 (with its histogram)
    up to 608; K = 512 takes 194 KB."""
    assert search_smem_bytes(512) == 198_656
    assert search_smem_bytes(640) <= SMEM_BYTES < search_smem_bytes(642)
    assert search_smem_bytes(608, with_hist=True) <= SMEM_BYTES < search_smem_bytes(
        610, with_hist=True)
