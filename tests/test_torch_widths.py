"""The kernels' functions at every width configs/hparams_search/optuna.yaml
samples, on the CPU, against the JAX package.

* the plain stems (K1/K1b, K2/K2b) at num_hidden 64, 128 and 256 against the
  Pallas stems in interpret mode, output and hidden, atol = rtol = 1e-5, and
  the 3xTF32 emulations where the 3xTF32 kernels run (64 and 128);
* the plain VQ search and fused forward fields (K3, #4) and the codebook
  gradient (#5) at each (K, D) of {128, 256, 512} x {64, 128, 256} against
  the Pallas kernels in interpret mode: ids and q bit-equal, counts equal,
  sq and the gradient at 1e-5;
* the kernels' arithmetic emulated at the new widths against fp64: the
  stems within chip_smoke.py's accumulation bound of the kernel that runs
  them (3xTF32 at num_hidden 64, fp32 FMA at 256; single-pass TF32 products
  outside both); the 3xTF32 search (``nearest_codes_3xtf32_ref``)
  every id the fp64 pick or a near-tie; the codebook gradient's order
  (``codebook_grad_order_ref`` over D / 64 column slices) bit-equal to a
  plain loop over the rows and within ``segment_sum_bound``;
* the wrappers' admission in pure Python: every width and (K, D) of
  optuna.yaml fits (the stems' width tables, ``search_smem_bytes``,
  ``segment_sum.smem_bytes``), a width outside them raises ``ValueError``
  naming it; each C entry point of ``csrc/`` takes the arguments
  ``_build.SIGNATURES`` gives it, and the fp32 entry points dispatch on
  exactly the widths of the wrappers' tables.
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
                                          conv_stem_3xtf32_ref, conv_stem_ref)
from msla_tpu_torch.ops.deconv_stem import (FP32_WIDTHS as DECONV_WIDTHS, deconv_stem_3xtf32_ref,
                                            deconv_stem_ref)
from msla_tpu_torch.ops._build import CSRC, SIGNATURES, SMEM_BYTES, refuse_widths
from msla_tpu_torch.ops.nearest_codes import (WIDTHS, check_codes, nearest_codes_3xtf32_ref,
                                              nearest_codes_ref, search_smem_bytes)
from msla_tpu_torch.ops.tf32 import tf32_round_ref
from msla_tpu_torch.ops.vq_fused import grad_smem_bytes, vq_codebook_grad_ref, vq_fused_fwd_ref

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
SPACE = yaml.safe_load((REPO / "configs/hparams_search/optuna.yaml").read_text())[
    "hydra"]["sweeper"]["params"]


def _choices(name: str) -> list[int]:
    spec = SPACE[f"model.vqvae.{name}"]
    return [int(v) for v in spec[spec.index("(") + 1:spec.index(")")].split(",")]


HIDDEN = _choices("num_hidden")                  # 64, 128, 256
FMA_HIDDEN = 256                                 # the stems' FMA kernels' width; 3xTF32 below
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
    if hidden != FMA_HIDDEN:
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
    if hidden != FMA_HIDDEN:
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


@pytest.mark.parametrize("hidden", [64, FMA_HIDDEN])
@pytest.mark.parametrize("transposed", [False, True], ids=["K1", "K2"])
def test_stem_bound_holds_at_the_new_widths(hidden, transposed):
    """num_hidden 64 runs the 3xTF32 kernels at (32, 64) and (64, 32): the
    plain fp32 stem and the 3xTF32 emulation, output and hidden, sit inside
    chip_smoke.py's 3xTF32 accumulation bound; 256 runs the fp32 FMA kernels:
    the plain stem sits inside the fp32 FMA bound. Single-pass TF32 products
    do not, and ``stem_fp64_share`` fails on them."""
    cs = _chip_smoke()
    fma = hidden == FMA_HIDDEN
    model = "fp32 FMA" if fma else "3xTF32"
    if transposed:
        args = _port(*_deconv_inputs(64, hidden, hidden // 2, seed=7))
        stems = [deconv_stem_ref(*args)] + ([] if fma else [deconv_stem_3xtf32_ref(*args)])
    else:
        args = _port(*_stem_inputs(256, hidden // 2, hidden, seed=8))
        stems = [conv_stem_ref(*args)] + ([] if fma else [conv_stem_3xtf32_ref(*args)])
    bounds = cs.stem_accumulation_bound(*args, transposed=transposed, fma=fma)
    for stem in stems:
        assert cs.stem_fp64_share("fp32", bounds, *stem, model=model) < 1
    with pytest.raises(RuntimeError, match=f"{model} accumulation"):
        cs.stem_fp64_share("one pass", bounds, *_one_pass(*args, transposed), model=model)


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
    for hidden in HIDDEN:
        assert (hidden // 2, hidden) in CONV_WIDTHS
        assert (hidden, hidden // 2) in DECONV_WIDTHS
        refuse_widths("conv_stem", (hidden // 2, hidden), CONV_WIDTHS)
    for k, d in CODES:
        assert d in WIDTHS
        for with_hist in (False, True):
            assert search_smem_bytes(k, with_hist, d) <= SMEM_BYTES
            check_codes("vq_fused_fwd", k, d, with_hist)
        assert grad_smem_bytes(k) <= SMEM_BYTES
    with pytest.raises(ValueError, match=r"\(48, 96\)"):
        refuse_widths("conv_stem", (48, 96), CONV_WIDTHS)
    with pytest.raises(ValueError, match=r"\(96, 48\)"):
        refuse_widths("deconv_stem", (96, 48), DECONV_WIDTHS)
    with pytest.raises(ValueError, match=r"\(32, 64\)"):  # bf16: the default widths only
        refuse_widths("conv_stem", (32, 64), ((C1, C2),))
    with pytest.raises(ValueError, match=r"\(96,\)"):
        check_codes("nearest_codes", 512, 96, False)
    with pytest.raises(ValueError, match="K=4500"):
        check_codes("vq_fused_fwd", 4500, 256, True)
    with pytest.raises(ValueError, match="K=513"):
        check_codes("nearest_codes", 513, 128, False)
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
    """One entry point a kernel family, each as SIGNATURES binds it; the fp32
    stems' and the VQ kernels' dispatch on the widths of FP32_WIDTHS and
    WIDTHS, no more and no fewer (C1, C2, CI name the default widths)."""
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
    for symbol in ("nearest_codes_fwd", "vq_fused_fwd"):
        cases = re.findall(r"case (\d+):", found[symbol][2])
        assert tuple(sorted(int(c) for c in cases)) == WIDTHS
