"""The kernels' functions at every width configs/hparams_search/optuna.yaml
samples, on the CPU, against the JAX package.

* the plain stems (K1/K1b, K2/K2b) at num_hidden 64, 128 and 256 against the
  Pallas stems in interpret mode, output and hidden, atol = rtol = 1e-5, and
  the 3xTF32 emulations, as the kernels sum at each width (at 256 conv2 as
  one partial sum a tap, K2's second layer as a cluster's four partials);
* the plain VQ search and fused forward fields (K3, #4) and the codebook
  gradient (#5) at each (K, D) of {128, 256, 512} x {64, 128, 256} against
  the Pallas kernels in interpret mode: ids and q bit-equal, counts equal,
  sq and the gradient at 1e-5;
* the kernels' arithmetic emulated at the new widths against fp64: the
  plain stems and the 3xTF32 emulations within chip_smoke.py's 3xTF32
  accumulation bound at num_hidden 64 and 256 (single-pass TF32 products
  outside it); the chains' order of the emulations at 256; the 3xTF32 search
  (``nearest_codes_3xtf32_ref``)
  every id the fp64 pick or a near-tie; the codebook gradient's order
  (``codebook_grad_order_ref`` over D / 64 column slices) bit-equal to a
  plain loop over the rows and within ``segment_sum_bound``;
* the wrappers' admission in pure Python: every width and (K, D) of
  optuna.yaml fits a tuned kernel (the stems' width tables,
  ``search_smem_bytes``, ``segment_sum.smem_bytes``), the widths the tables
  lack run on the any-width kernels, one past each limit raises
  ``ValueError`` naming it; each C entry point of ``csrc/`` takes the
  arguments ``_build.SIGNATURES`` gives it, the tuned fp32 entry points
  dispatch on exactly the widths of the wrappers' tables and the
  any-width ones on none (tests/test_torch_any_width.py holds the rest).
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from _torch_layout import ncw, t32, torch_weight
from msla_tpu.ops import vq_fused as jax_vq_fused
from msla_tpu.ops.conv_stem import conv_stem_pallas
from msla_tpu.ops.deconv_stem import deconv_stem_pallas
from msla_tpu.ops.vq_pallas import nearest_codes_pallas
from msla_tpu_torch.ops import segment_sum
from msla_tpu_torch.ops.conv_stem import (C1, C2, FP32_WIDTHS as CONV_WIDTHS,
                                          conv_stem_3xtf32_ref, conv_stem_ref, stem_operands)
from msla_tpu_torch.ops.deconv_stem import (FP32_WIDTHS as DECONV_WIDTHS, deconv_stem_3xtf32_ref,
                                            deconv_stem_ref, phase_operands)
from msla_tpu_torch.ops._build import CSRC, SIGNATURES, SMEM_BYTES
from msla_tpu_torch.ops.conv_stem import plan_stem as conv_plan
from msla_tpu_torch.ops.deconv_stem import plan_stem as deconv_plan
from msla_tpu_torch.ops.nearest_codes import (WIDTHS, nearest_codes_3xtf32_ref, nearest_codes_ref,
                                              plan_search, search_smem_bytes, tuned_takes)
from msla_tpu_torch.ops.tf32 import product_3xtf32, tf32_round_ref
from msla_tpu_torch.ops.vq_fused import (grad_smem_bytes, plan_grad, vq_codebook_grad_ref,
                                         vq_fused_fwd_ref)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
SPACE = yaml.safe_load((REPO / "configs/hparams_search/optuna.yaml").read_text())[
    "hydra"]["sweeper"]["params"]


def _choices(name: str) -> list[int]:
    spec = SPACE[f"model.vqvae.{name}"]
    return [int(v) for v in spec[spec.index("(") + 1:spec.index(")")].split(",")]


HIDDEN = _choices("num_hidden")                  # 64, 128, 256
CODES = [(k, d) for k in _choices("num_embedding") for d in _choices("embedding_dim")]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stem_inputs(t, c1, c2, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t, 4)).astype(np.float32),
            (rng.standard_normal((4, 4, c1)) * 0.2).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, c1, c2)) * (0.5 / np.sqrt(c1))).astype(np.float32),
            (rng.standard_normal((c2,)) * 0.1).astype(np.float32))


def _deconv_inputs(w, c, c1, seed):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((2, w, c))).astype(np.float32),
            (rng.standard_normal((4, c1, c)) * (0.5 / np.sqrt(c))).astype(np.float32),
            (rng.standard_normal((c1,)) * 0.1).astype(np.float32),
            (rng.standard_normal((4, 4, c1)) * (0.5 / np.sqrt(c1))).astype(np.float32),
            (rng.standard_normal((4,)) * 0.1).astype(np.float32))


def _port(x, w1, b1, w2, b2):
    return ncw(x), torch_weight(w1), t32(b1), torch_weight(w2), t32(b2)


@pytest.mark.parametrize("hidden", HIDDEN)
def test_encoder_stem_matches_jax_pallas_at_sweep_width(hidden):
    args = _stem_inputs(96, hidden // 2, hidden, seed=hidden)
    want, want_h = conv_stem_pallas(*args, save_hidden=True, tile_w=8, interpret=True)
    got, h1 = conv_stem_ref(*_port(*args))
    assert got.shape == (2, hidden, 24) and h1.shape == (2, hidden // 2, 48)
    np.testing.assert_allclose(got.numpy(), ncw(want).numpy(), **TOL)
    np.testing.assert_allclose(h1.numpy(), ncw(want_h).numpy(), **TOL)
    got, h1 = conv_stem_3xtf32_ref(*_port(*args))
    np.testing.assert_allclose(got.numpy(), ncw(want).numpy(), **TOL)
    np.testing.assert_allclose(h1.numpy(), ncw(want_h).numpy(), **TOL)


@pytest.mark.parametrize("hidden", HIDDEN)
def test_decoder_stem_matches_jax_pallas_at_sweep_width(hidden):
    args = _deconv_inputs(24, hidden, hidden // 2, seed=hidden + 1)
    want, want_h = deconv_stem_pallas(*args, save_hidden=True, tile_w=8, interpret=True)
    got, h = deconv_stem_ref(*_port(*args))
    assert got.shape == (2, 4, 96) and h.shape == (2, hidden // 2, 48)
    np.testing.assert_allclose(got.numpy(), ncw(want).numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), ncw(want_h).numpy(), **TOL)
    got, h = deconv_stem_3xtf32_ref(*_port(*args))
    np.testing.assert_allclose(got.numpy(), ncw(want).numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), ncw(want_h).numpy(), **TOL)


@pytest.mark.parametrize("k,d", CODES)
def test_vq_fields_and_codebook_grad_match_jax_pallas(k, d):
    rng = np.random.default_rng(k + d)
    flat = rng.standard_normal((200, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    ids = nearest_codes_pallas(jnp.asarray(flat), jnp.asarray(cb), interpret=True)
    want = jax_vq_fused.vq_fused_fwd_pallas(jnp.asarray(flat), jnp.asarray(cb), tile=64,
                                            interpret=True)
    q, idx, counts, sq = vq_fused_fwd_ref(torch.from_numpy(flat), torch.from_numpy(cb))
    np.testing.assert_array_equal(nearest_codes_ref(torch.from_numpy(flat),
                                                    torch.from_numpy(cb)).numpy(),
                                  np.asarray(ids))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]).reshape(-1))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(float(sq), float(want[3]), rtol=1e-5)
    g = rng.standard_normal((200, d)).astype(np.float32)
    dcb = vq_codebook_grad_ref(torch.from_numpy(g), idx, k)
    kernel = jax_vq_fused.vq_codebook_grad_pallas(jnp.asarray(g), jnp.asarray(idx.numpy()), k,
                                                  tile=64, interpret=True)
    np.testing.assert_allclose(dcb.numpy(), np.asarray(kernel), **TOL)


def _one_pass(x, w1, b1, w2, b2, transposed):
    """The stem with single-pass TF32 products."""
    conv = F.conv_transpose1d if transposed else F.conv1d
    r = tf32_round_ref
    h = torch.relu(conv(r(x), r(w1), b1, 2, 1))
    out = conv(r(h), r(w2), b2, 2, 1)
    return (out if transposed else torch.relu(out)), h


@pytest.mark.parametrize("hidden", [64, 256])
@pytest.mark.parametrize("transposed", [False, True], ids=["K1", "K2"])
def test_stem_bound_holds_at_the_new_widths(hidden, transposed):
    """num_hidden 64 and 256 run the 3xTF32 kernels at (32, 64) and (64, 32),
    (128, 256) and (256, 128): the plain fp32 stem and the 3xTF32 emulation,
    output and hidden, sit inside chip_smoke.py's 3xTF32 accumulation bound
    (at 256 with the constant of the kernels' extra partial sums);
    single-pass TF32 products do not, and ``stem_fp64_share`` fails on
    them."""
    cs = _chip_smoke()
    if transposed:
        args = _port(*_deconv_inputs(64, hidden, hidden // 2, seed=7))
        stems = [deconv_stem_ref(*args), deconv_stem_3xtf32_ref(*args)]
    else:
        args = _port(*_stem_inputs(256, hidden // 2, hidden, seed=8))
        stems = [conv_stem_ref(*args), conv_stem_3xtf32_ref(*args)]
    bounds = cs.stem_accumulation_bound(*args, transposed=transposed)
    for stem in stems:
        assert cs.stem_fp64_share("fp32", bounds, *stem) < 1
    with pytest.raises(RuntimeError, match="3xTF32 accumulation"):
        cs.stem_fp64_share("one pass", bounds, *_one_pass(*args, transposed))


@pytest.mark.parametrize("transposed", [False, True], ids=["K1", "K2"])
def test_3xtf32_emulation_sums_in_the_kernels_order_at_256(transposed):
    """At num_hidden 256 the emulation's layers are the kernels' partial sums
    added in order, rebuilt here from its own hidden: K1's conv2 one 3xTF32
    chain a tap over 128 rows of the depth, relu((((P0 + P1) + P2) + P3) +
    b2); K2's first layer a chain over W1''s q[r-1] columns plus one over
    its q[r] columns, + b1, and its second layer, for each of the cluster's 4
    blocks, a chain over its 32 channels of row sets 0-1 plus one over row
    sets 2-3, the blocks' partials added in block order, + b2. One chain over
    the whole depth gives other bits."""
    if transposed:
        q, w1, b1, w2, b2 = _port(*_deconv_inputs(24, 256, 128, seed=9))
        out, h = deconv_stem_3xtf32_ref(q, w1, b1, w2, b2)
        zero = h.new_zeros((2, 128, 1))
        he = torch.cat([h[..., 0::2], zero], 2)          # he[r] = h[2r], r = 0 .. W
        ho = torch.cat([zero, h[..., 1::2]], 2)          # ho[r] = h[2r - 1]
        rows = torch.cat([he[..., :-1], ho[..., :-1], ho[..., 1:], he[..., 1:]], 1)
        w1p, w2p = phase_operands(w1, w2)
        qp = F.pad(q, (1, 1))                            # q[-1] .. q[W]
        cols = torch.cat([qp[..., :-1], qp[..., 1:]], 1)  # [q[r-1]; q[r]], r = 0 .. W
        pre = product_3xtf32(w1p[:, :256], cols[:, :256]) + product_3xtf32(w1p[:, 256:],
                                                                           cols[:, 256:])
        hr = torch.relu(pre + b1.repeat(2)[:, None])     # [he[r]; ho[r - 1]]
        assert torch.equal(h[..., 0::2], hr[:, :128, :24])
        assert torch.equal(h[..., 1::2], hr[:, 128:, 1:])
        assert not torch.equal(pre, product_3xtf32(w1p, cols))

        def chain(k):
            return product_3xtf32(rows[:, k].transpose(1, 2), w2p[:, k].T)

        def group(r, sets):
            return chain(torch.cat([torch.arange(128 * s + 32 * r, 128 * s + 32 * r + 32)
                                    for s in sets]))

        def packed(sums):
            y = sums.transpose(1, 2) + b2.repeat_interleave(4)[:, None]
            return y.view(2, 4, 4, 24).transpose(2, 3).flatten(2)

        parts = [group(r, (0, 1)) + group(r, (2, 3)) for r in range(4)]
        want = packed(((parts[0] + parts[1]) + parts[2]) + parts[3])
        whole = packed(chain(torch.arange(512)))
    else:
        x, w1, b1, w2, b2 = _port(*_stem_inputs(96, 128, 256, seed=10))
        out, h1 = conv_stem_3xtf32_ref(x, w1, b1, w2, b2)
        h = h1.transpose(1, 2)                           # (B, T/2, C1)
        zero = h.new_zeros((2, 1, 128))
        h_e = torch.cat([h[:, 0::2], zero], 1)           # hE[i] = h1[2i], i = 0 .. T/4
        h_o = torch.cat([zero, h[:, 1::2]], 1)           # hO[i] = h1[2i - 1]
        taps = torch.cat([h_o[:, :-1], h_e[:, :-1], h_o[:, 1:], h_e[:, 1:]], 2)
        w2p = stem_operands(w1, w2)[1]

        def chain(s):
            return product_3xtf32(w2p[:, s], taps[..., s].transpose(1, 2)).transpose(1, 2)

        parts = [chain(slice(128 * tap, 128 * (tap + 1))) for tap in range(4)]
        want = torch.relu(((parts[0] + parts[1]) + parts[2]) + parts[3] + b2).transpose(1, 2)
        whole = torch.relu(chain(slice(0, 512)) + b2).transpose(1, 2)
    assert torch.equal(out, want)
    assert not torch.equal(out, whole)


@pytest.mark.parametrize("d", [128, 256])
def test_3xtf32_search_emulation_against_fp64(d):
    """K3's and #4's products at the streamed widths: every id of
    ``nearest_codes_3xtf32_ref`` is the fp64 pick or within chip_smoke.py's
    near-tie limit of it, and it picks right on chip_smoke.py's planted ties
    and close pairs (``vq_planted``), which one TF32 pass gets wrong."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn((512, d), generator=g)
    cb = torch.randn((512, d), generator=g)
    cs = _chip_smoke()
    ids = nearest_codes_3xtf32_ref(x, cb)
    exact = ((cb.double() ** 2).sum(1) - 2 * x.double() @ cb.double().T).argmin(1)
    cs.near_ties(x, cb, ids, exact)
    for close in (False, True):  # chip_smoke.py's planted ties and close pairs at this D
        rows, planted, want = cs.vq_planted(cb, close, g, n=128)
        assert torch.equal(nearest_codes_3xtf32_ref(rows, planted).long(), want)
    r = tf32_round_ref
    one_pass = ((r(planted) ** 2).sum(1) - 2 * r(rows) @ r(planted).T).argmin(1)
    assert (one_pass != want).any()


@pytest.mark.parametrize("d", [128, 256])
def test_codebook_grad_order_over_column_slices(d):
    """#5 at D > 64 runs its D = 64 kernel on each 64-column slice at the
    slice's grid: ``codebook_grad_order_ref`` on (N, D) is, column by column,
    the order on each slice, bit for bit; equal to a plain loop that adds in
    that order, and within ``segment_sum_bound`` of fp64."""
    g = torch.Generator().manual_seed(d)
    n, k, blocks = 1000, 128, 8
    grad = torch.randn((n, d), generator=g)
    ids = torch.randint(0, k, (n,), generator=g, dtype=torch.int32)
    whole = segment_sum.codebook_grad_order_ref(grad, ids, k, blocks)
    sliced = torch.cat([segment_sum.codebook_grad_order_ref(grad[:, s:s + 64].contiguous(),
                                                            ids, k, blocks)
                        for s in range(0, d, 64)], 1)
    assert torch.equal(whole, sliced)
    parts = blocks
    rows = segment_sum.rows_per_part(n, parts, False)
    loop = torch.zeros((parts, k, d))
    for p in range(parts):  # each 32-row group's codes in ascending rows
        for g0 in range(p * rows, min(n, (p + 1) * rows), 32):
            group = torch.zeros((k, d))
            seen = torch.zeros(k, dtype=torch.bool)
            for r in range(g0, min(n, g0 + 32, (p + 1) * rows)):
                c = int(ids[r])
                group[c] = grad[r] if not seen[c] else group[c] + grad[r]
                seen[c] = True
            loop[p][seen] = loop[p][seen] + group[seen]
    clusters = loop.view(parts // 4, 4, k, d)
    per = clusters[:, 0] + clusters[:, 1] + clusters[:, 2] + clusters[:, 3]
    want = per[0]
    for c in range(1, per.shape[0]):
        want = want + per[c]
    assert torch.equal(whole, want)
    err = (whole.double() - segment_sum.segment_sum_fp64(grad, ids, k)).abs()
    depth = segment_sum.summation_depth(n, blocks)
    assert (err <= segment_sum.segment_sum_bound(grad, ids, k, depth)).all()


def test_every_sweep_width_is_admitted_and_others_refused():
    """Every width optuna.yaml samples runs on a tuned kernel (the tables,
    ``tuned_takes``); every width in range runs, the ones the tables lack on
    the any-width kernels (``plan_stem``, ``plan_search``, ``plan_grad``);
    one past each limit raises ``ValueError`` naming the width."""
    for hidden in HIDDEN:
        assert (hidden // 2, hidden) in CONV_WIDTHS
        assert (hidden, hidden // 2) in DECONV_WIDTHS
        assert conv_plan(hidden // 2, hidden).symbol == "conv_stem_fwd"
        assert deconv_plan(hidden, hidden // 2).symbol == "deconv_stem_fwd"
    for k, d in CODES:
        assert d in WIDTHS
        for with_hist in (False, True):
            assert search_smem_bytes(k, with_hist, d) <= SMEM_BYTES
            assert tuned_takes(k, d, with_hist)
            assert plan_search(k, d, with_hist).design in ("shared", "ring")
        assert grad_smem_bytes(k) <= SMEM_BYTES
        assert plan_grad(k, d).runs == 1
    # what the tables refused runs on the any-width kernels
    assert conv_plan(48, 96).symbol == "conv_stem_any_fwd"
    assert deconv_plan(96, 48).symbol == "deconv_stem_any_fwd"
    # bf16's table holds (64, 128) alone
    assert conv_plan(32, 64, torch.bfloat16).symbol == "conv_stem_any_fwd"
    assert plan_search(512, 96).design == "any width"
    assert plan_search(8346, 256, True).design == "any width"  # the ring's histogram: 8,344
    assert plan_search(513, 128).design == "any width"
    assert plan_grad(8346, 256).runs == 12
    # one past each limit
    with pytest.raises(ValueError, match=r"\(C1, C2\) = \(257, 514\)"):
        conv_plan(257, 514)
    with pytest.raises(ValueError, match=r"\(C, C1\) = \(514, 257\)"):
        deconv_plan(514, 257)
    with pytest.raises(ValueError, match="D=513"):
        plan_search(512, 513)
    with pytest.raises(ValueError, match="K=65537"):
        plan_search(65_537, 64, True)
    with pytest.raises(ValueError, match="K=65537"):
        plan_grad(65_537, 64)
    # the tuned tables lack them
    assert (48, 96) not in CONV_WIDTHS and (96, 48) not in DECONV_WIDTHS
    assert not tuned_takes(512, 96, False)
    assert not tuned_takes(8346, 256, True)
    assert not tuned_takes(513, 128, False)
    assert search_smem_bytes(512, True) == 200_768   # the D = 64 design's, unchanged


def _entry_points() -> dict[str, tuple[str, int, str]]:
    """Each ``extern "C"`` function of csrc/*.cu: (source, argument count, body)."""
    out = {}
    for path in CSRC.glob("*.cu"):
        text = path.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)\s*\{(.*?)\n\}', text, re.S):
            params = [a for a in m.group(2).split(",") if a.strip()]
            out[m.group(1)] = (path.stem, len(params), m.group(3))
    return out


def test_entry_points_match_signatures_and_width_tables():
    """Each entry point as SIGNATURES binds it; the tuned fp32 stems' and VQ
    kernels' dispatch on the widths of FP32_WIDTHS and WIDTHS, no more and no
    fewer (C1, C2, CI name the default widths); the any-width entry points
    take their widths as values and switch on none; the plans name only
    entry points of SIGNATURES, the tuned ones exactly at the tables'
    widths."""
    found = _entry_points()
    assert {k: v[:2] for k, v in found.items()} == {
        k: (source, len(args)) for k, (source, args) in SIGNATURES.items()}
    default = {"C1": C1, "C2": C2, "CI": C2}
    for symbol, table, names in (("conv_stem_fwd", CONV_WIDTHS, ("c1", "c2")),
                                 ("conv_stem_smem_bytes", CONV_WIDTHS, ("c1", "c2")),
                                 ("deconv_stem_fwd", DECONV_WIDTHS, ("c", "c1")),
                                 ("deconv_stem_smem_bytes", DECONV_WIDTHS, ("c", "c1"))):
        pairs = re.findall(rf"if \({names[0]} == (\w+) && {names[1]} == (\w+)\)",
                           found[symbol][2])
        assert sorted(tuple(int(default.get(v, v)) for v in p) for p in pairs) == sorted(table)
    for symbol in ("nearest_codes_fwd", "vq_fused_fwd", "vq_search_smem_bytes"):
        cases = re.findall(r"case (\d+):", found[symbol][2])
        assert tuple(sorted(int(c) for c in cases)) == WIDTHS
    for symbol in ("conv_stem_any_fwd", "deconv_stem_any_fwd", "stem_any_smem_bytes",
                   "vq_any_fwd", "vq_any_smem_bytes"):
        assert not re.search(r"case \d+:|\b(c|c1|c2|d) == \d+", found[symbol][2])
    for dtype, tuned in ((torch.float32, set(CONV_WIDTHS)), (torch.bfloat16, {(C1, C2)})):
        for hidden in range(2, 513):
            widths = (hidden // 2, hidden)
            plan, dplan = conv_plan(*widths, dtype), deconv_plan(hidden, hidden // 2, dtype)
            assert plan.symbol in SIGNATURES and dplan.symbol in SIGNATURES
            assert (plan.symbol != "conv_stem_any_fwd") == (widths in tuned)
            assert (dplan.symbol != "deconv_stem_any_fwd") == (widths in tuned)
