"""The fused VQ's precision variants and their tool on the CPU, against the JAX
tool's own functions (tools/bench_vq_precision.py ``make_fwd``, ``make_bwd``,
their Pallas kernels run in interpret mode, as tests/test_flash_attn.py runs
one).

N = 4,100 rows (two full 2,048-row tiles of the JAX kernels and a ragged one,
whose padded rows the counts and sums must not see), K = 512 (``make_bwd``
fixes it), D = 64; the inputs are the tool's own, drawn from
``default_rng(0)``. Forward: ids equal, or each differing row a near-tie on
the mode's own distance in fp64 (bf16-rounded operands for bf16, the three
products for split3; gap below 1e-5 relative); counts and q bit-equal where
the ids are equal; sq at rtol 1e-5 (the diff² sum in another order).
Gradient: within 1e-5 of the largest |entry| of JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from msla_tpu_torch.ops._build import launch_count
from msla_tpu_torch.ops.vq_fused import vq_fused_fwd_ref
from msla_tpu_torch.ops.vq_precision import (split_bf16, vq_precision_bwd, vq_precision_bwd_ref,
                                             vq_precision_fwd, vq_precision_fwd_ref)
from msla_tpu_torch.tools import bench_vq_precision
from tools import bench_vq_precision as jax_tool

N, K = 4100, 512


@pytest.fixture(scope="module")
def tool_inputs():
    return bench_vq_precision.inputs(N)


def _mode_dist(x, cb, dist_mode):
    """(N, K) distances in fp64 on the mode's own operands."""
    (xh, xl), (ch, cl) = ([p.double().numpy() for p in split_bf16(t)] for t in (x, cb))
    if dist_mode == "f32":
        e, dots = cb.double().numpy(), x.double().numpy() @ cb.double().numpy().T
    elif dist_mode == "bf16":
        e, dots = ch, xh @ ch.T
    else:
        e, dots = ch + cl, xh @ ch.T + xh @ cl.T + xl @ ch.T
    return (e ** 2).sum(1) - 2.0 * dots


@pytest.mark.parametrize("dist_mode,quant_mode", [m for _, m in bench_vq_precision.FWD_MODES])
def test_forward_matches_jax_tool(tool_inputs, dist_mode, quant_mode):
    x, cb, _ = tool_inputs
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jax_tool.make_fwd(dist_mode, quant_mode)(
            jnp.asarray(x.numpy()), jnp.asarray(cb.numpy()))]
    q, idx, counts, sq = (t.numpy() for t in vq_precision_fwd(x, cb, dist_mode, quant_mode))
    assert q.shape == (N, 64) and idx.shape == (N, 1) and idx.dtype == np.int32
    assert counts.shape == (1, K) and sq.shape == (1, 1)

    got_ids, want_ids = idx[:, 0], want[1][:N, 0]
    rows = np.nonzero(got_ids != want_ids)[0]
    dist = _mode_dist(x, cb, dist_mode)
    a, b = dist[rows, got_ids[rows]], dist[rows, want_ids[rows]]
    assert (np.abs(a - b) / (np.abs(b) + 1) < 1e-5).all(), rows
    same = got_ids == want_ids
    np.testing.assert_array_equal(q[same], want[0][:N][same])
    np.testing.assert_array_equal(counts[0], np.bincount(got_ids, minlength=K))
    if not rows.size:
        np.testing.assert_array_equal(counts, want[2])
    np.testing.assert_allclose(sq, want[3], rtol=1e-5)


@pytest.mark.parametrize("mode", bench_vq_precision.BWD_MODES)
def test_backward_matches_jax_tool(tool_inputs, mode):
    x, cb, g = tool_inputs
    idx = vq_fused_fwd_ref(x, cb)[1]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tool.make_bwd(mode)(jnp.asarray(g.numpy()),
                                                  jnp.asarray(idx.numpy())))
    got = vq_precision_bwd(g, idx, mode).numpy()
    assert got.shape == (K, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_f32_pair_is_the_fused_forward(tool_inputs):
    x, cb, _ = tool_inputs
    q, idx, counts, sq = vq_fused_fwd_ref(x, cb)
    for got, want in zip(vq_precision_fwd(x, cb, "f32", "f32"),
                         (q, idx[:, None], counts[None], sq.reshape(1, 1))):
        assert torch.equal(got, want)


def test_tool_main_runs_on_the_cpu(capsys):
    out = bench_vq_precision.main(device="cpu", n=N)
    lines = capsys.readouterr().out.splitlines()
    names = [n for n, _ in bench_vq_precision.FWD_MODES]
    assert [line.split()[:2] for line in lines] == (
        [["fwd", n] for n in names] + [["bwd", n] for n in bench_vq_precision.BWD_MODES])
    assert list(out["fwd"]) == names and list(out["bwd"]) == list(bench_vq_precision.BWD_MODES)
    assert out["fwd"]["f32/f32"]["idx_mismatch"] == 0
    assert out["fwd"]["split3/split2"]["sq_rel_err"] < 1e-5
    assert 0 < out["bwd"]["split2"]["rel_err"] < 1e-5
    assert all(r["ms"] > 0 for r in (*out["fwd"].values(), *out["bwd"].values()))


@pytest.mark.parametrize("call", [
    lambda x, cb, g, i: bench_vq_precision.make_fwd("fp16", "f32"),
    lambda x, cb, g, i: bench_vq_precision.make_fwd("bf16", "split3"),
    lambda x, cb, g, i: bench_vq_precision.make_bwd("bf16"),
    lambda x, cb, g, i: vq_precision_fwd(x, cb, "tf32", "f32"),
    lambda x, cb, g, i: vq_precision_fwd_ref(x, cb, "bf16", "bf16"),
    lambda x, cb, g, i: vq_precision_bwd(g, i, "split3"),
    lambda x, cb, g, i: vq_precision_bwd_ref(g, i, "f16"),
], ids=["make_fwd dist", "make_fwd quant", "make_bwd", "fwd", "fwd_ref", "bwd", "bwd_ref"])
def test_bad_modes_raise(call):
    x, cb, g = bench_vq_precision.inputs(8)
    with pytest.raises(ValueError, match="mode"):
        call(x, cb, g, torch.zeros((8,), dtype=torch.int32))


def test_wrappers_on_cpu_run_the_plain_versions():
    x, cb, g = bench_vq_precision.inputs(300)
    idx = vq_fused_fwd_ref(x, cb)[1]
    before = launch_count(vq_precision_fwd), launch_count(vq_precision_bwd)
    for a, b in zip(vq_precision_fwd(x, cb, "split3", "split2"),
                    vq_precision_fwd_ref(x, cb, "split3", "split2")):
        assert torch.equal(a, b)
    assert torch.equal(vq_precision_bwd(g, idx, "split2"),
                       vq_precision_bwd_ref(g, idx, "split2"))
    assert (launch_count(vq_precision_fwd), launch_count(vq_precision_bwd)) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        vq_precision_fwd(x.to("meta"), cb.to("meta"), "bf16", "f32")
