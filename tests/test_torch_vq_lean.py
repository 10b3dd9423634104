"""The lean fused-VQ forward and its tool on the CPU, against the JAX tool's own
function (tools/bench_vq_lean.py ``vq_lean_fwd``, its Pallas kernel run in
interpret mode, as tests/test_flash_attn.py runs one).

N = 4,100 rows: two full 2,048-row tiles of the JAX kernel and a ragged one,
whose padded rows the counts and the sum must not see. The inputs are the
tool's own, drawn from ``default_rng(0)``. Ids equal, or each differing row a
near-tie (fp64 distance gap below 1e-5 relative); counts and q bit-equal
where the ids are equal; sq within 1e-5 relative plus ``sq_error_bound``,
the spread of the algebraic sum's fp32 cancellation (the converged regime
shows it: ≈ 6e-4 relative between the two here, under a bound of ≈ 3e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.vq_lean import sq_error_bound, vq_lean_fwd, vq_lean_fwd_ref
from msla_tpu_torch.tools import bench_vq_lean
from tools import bench_vq_lean as jax_tool

N = 4100


def _near_tie_rows(got, want, dist):
    """Rows where two id vectors differ; fails unless each is a near-tie."""
    rows = np.nonzero(got != want)[0]
    a, b = dist[rows, got[rows]], dist[rows, want[rows]]
    assert (np.abs(a - b) / (np.abs(b) + 1) < 1e-5).all(), rows
    return rows


@pytest.mark.parametrize("regime", ["random", "converged"])
def test_lean_forward_matches_jax_tool(regime):
    cb, x_rand, x_conv = bench_vq_lean.inputs(N)
    x = x_rand if regime == "random" else x_conv
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jax_tool.vq_lean_fwd(jnp.asarray(x.numpy()),
                                                            jnp.asarray(cb.numpy()))]
    q, idx, counts, sq = (t.numpy() for t in vq_lean_fwd(x, cb))
    assert q.shape == (N, 64) and idx.shape == (N,) and idx.dtype == np.int32
    assert counts.shape == (512,) and sq.shape == ()

    x64, cb64 = x.double().numpy(), cb.double().numpy()
    dist = (cb64 ** 2).sum(1) - 2.0 * x64 @ cb64.T
    flipped = _near_tie_rows(idx, want[1], dist)
    same = idx == want[1]
    np.testing.assert_array_equal(q[same], want[0][same])
    np.testing.assert_array_equal(counts, np.bincount(idx, minlength=512))
    if not flipped.size:
        np.testing.assert_array_equal(counts, want[2])
    bound = sq_error_bound(x)
    assert abs(float(sq) - float(want[3])) <= 1e-5 * abs(float(want[3])) + bound
    exact = ((cb64[idx] - x64) ** 2).sum()  # the diff² form in fp64
    assert abs(float(sq) - exact) <= 1e-5 * exact + bound


def test_tool_main_runs_on_the_cpu(capsys):
    out = bench_vq_lean.main(device="cpu", n=N)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ["[random]", "[converged]", "fwd", "fwd"]
    for regime in ("random", "converged"):
        assert out[regime]["idx_mismatch"] == 0 and out[regime]["counts_equal"]
        assert out[regime]["q_max_err"] == 0.0
    assert out["random"]["sq_rel_err"] < 1e-5
    assert out["converged"]["sq_rel_err"] < 1e-5 + sq_error_bound(
        bench_vq_lean.inputs(N)[2]) / out["converged"]["sq"]
    assert out["shipping_ms"] > 0 and out["lean_ms"] > 0


def test_tool_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main() runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_vq_lean.main(n=8)


def test_wrapper_on_cpu_runs_the_plain_version():
    cb, x, _ = bench_vq_lean.inputs(300)
    before = launch_count(vq_lean_fwd)
    for a, b in zip(vq_lean_fwd(x, cb), vq_lean_fwd_ref(x, cb)):
        assert torch.equal(a, b)
    assert launch_count(vq_lean_fwd) == before


def test_wrapper_rejects_a_device_it_has_no_path_for():
    with pytest.raises(ValueError, match="cpu or cuda"):
        vq_lean_fwd(torch.empty((4, 64), device="meta"), torch.empty((8, 64), device="meta"))
