"""The VQ tools' kernels as redesigned for Hopper, on the CPU against the JAX
tools' own functions (tools/bench_vq_lean.py ``vq_lean_fwd``,
tools/bench_vq_precision.py ``make_fwd``, their Pallas kernels run in
interpret mode, as tests/test_torch_vq_lean.py runs them).

- #8 (``csrc/vq_lean.cu``) searches as K3 and #4 do, in 3xTF32 on the tensor
  cores: the search's emulation (``nearest_codes_3xtf32_ref``) at the lean
  tool's inputs, N = 4,100 rows and K = 512 codes, in both of its regimes,
  gives ids equal to the JAX tool's or near-ties (fp64 gap below 1e-5 of
  |dist| + 1), and the sum built from those ids as the kernel builds it
  (‖x‖² + ‖e‖² − 2·x·e a row in fp32, the rows in fp64) is within 1e-5
  relative plus ``sq_error_bound`` of the JAX tool's.
- #9's forward (``csrc/vq_precision.cu``) is held on the card to planted
  ties of its own operands (``chip_smoke.py::vq_bf16_planted``: codes equal
  in cb_hi and cb_lo, apart in fp32): the JAX ``make_fwd`` and the plain
  version give every row the lower index in each compiled mode.
- The wrappers' K limits, from the Python helpers that mirror the kernels'
  shared memory: K = 512 fits every compiled mode, and the first K past each
  limit is refused.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from msla_tpu_torch.ops._build import SMEM_BYTES
from msla_tpu_torch.ops.nearest_codes import (code_norms, nearest_codes_3xtf32_ref,
                                              search_smem_bytes)
from msla_tpu_torch.ops.vq_lean import check_codes as lean_check_codes
from msla_tpu_torch.ops.vq_lean import sq_error_bound
from msla_tpu_torch.ops.vq_precision import COMPILED, fwd_smem_bytes, vq_precision_fwd_ref
from msla_tpu_torch.ops.vq_precision import check_codes as precision_check_codes
from msla_tpu_torch.tools import bench_vq_lean
from tools import bench_vq_lean as jax_lean
from tools import bench_vq_precision as jax_precision

N, K = 4100, 512
MODES = sorted(COMPILED)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("regime", ["random", "converged"])
def test_lean_search_emulation_matches_jax_tool(regime):
    cb, x_rand, x_conv = bench_vq_lean.inputs(N)
    x = x_rand if regime == "random" else x_conv
    with pltpu.force_tpu_interpret_mode():
        _, want_idx, _, want_sq = (np.asarray(a) for a in jax_lean.vq_lean_fwd(
            jnp.asarray(x.numpy()), jnp.asarray(cb.numpy())))
    idx = nearest_codes_3xtf32_ref(x, cb)
    _chip_smoke().near_ties(x, cb, idx, torch.from_numpy(want_idx.copy()))

    e = cb[idx.long()]
    m = code_norms(cb)[idx.long()] - 2.0 * (x * e).sum(1)
    sq = ((x * x).sum(1) + m).double().sum().item()
    assert abs(sq - float(want_sq)) <= 1e-5 * abs(float(want_sq)) + sq_error_bound(x)


@pytest.mark.parametrize("dist_mode,quant_mode", MODES)
def test_planted_bf16_ties_go_to_the_lower_index(dist_mode, quant_mode):
    g = torch.Generator().manual_seed(12)
    x, e, want = _chip_smoke().vq_bf16_planted(g, torch.device("cpu"))
    with pltpu.force_tpu_interpret_mode():
        jax_ids = np.asarray(jax_precision.make_fwd(dist_mode, quant_mode)(
            jnp.asarray(x.numpy()), jnp.asarray(e.numpy()))[1])[:x.shape[0], 0]
    plain_ids = vq_precision_fwd_ref(x, e, dist_mode, quant_mode)[1][:, 0]
    np.testing.assert_array_equal(jax_ids, want.numpy())
    assert torch.equal(plain_ids.long(), want)


def test_lean_k_limit_is_the_search_with_its_histogram():
    """#8 takes #4's K: the search's codebook, |e|^2 and x tiles and the
    histogram in shared memory, an even K up to 608."""
    assert search_smem_bytes(608, with_hist=True) <= SMEM_BYTES < search_smem_bytes(
        610, with_hist=True)
    lean_check_codes(512)
    lean_check_codes(608)
    for k in (610, 511):
        with pytest.raises(ValueError, match="vq_lean_fwd"):
            lean_check_codes(k)


@pytest.mark.parametrize("dist_mode,quant_mode", MODES)
def test_precision_k_limit_from_its_shared_memory(dist_mode, quant_mode):
    """#9's forward takes a multiple of 64 codes whose shared memory fits:
    512 with cb_lo (split3's products, split2's q), 1,024 without."""
    fits = [k for k in range(64, 4096, 64)
            if fwd_smem_bytes(k, dist_mode, quant_mode) <= SMEM_BYTES]
    assert fits == list(range(64, fits[-1] + 1, 64))
    assert fits[-1] == (1024 if (dist_mode, quant_mode) == ("bf16", "f32") else 512)
    precision_check_codes(K, dist_mode, quant_mode)
    for k in (fits[-1] + 64, 100):
        with pytest.raises(ValueError, match="vq_precision_fwd"):
            precision_check_codes(k, dist_mode, quant_mode)
