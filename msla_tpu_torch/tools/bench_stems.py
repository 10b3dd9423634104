"""Where the hand-written kernels' time goes: the fp32 stems (K1/K1b
``csrc/conv_stem.cu``, K2/K2b ``csrc/deconv_stem.cu``), the VQ search (K3
``csrc/nearest_codes.cu``, #4 ``csrc/vq_fused.cu``'s forward and #8
``csrc/vq_lean.cu``, all on ``csrc/vq_search.cuh``), in 3xTF32, #9's
forwards (``csrc/vq_precision.cu``: bf16/split2, bf16/f32 and split3/split2
on bf16 ``wgmma``) and the two segment sums (#5 ``csrc/vq_fused.cu``'s
codebook gradient and #9's split2 gradient, both ``csrc/segment_sum.cuh``, on
uniform ids and on one code for every row), timed on the card at a batch-64
call's shapes (the stems; N = 704,000 rows against 512 codes for the VQ
kernels), beside builds of the same sources with part of the work taken out,
or another layout, and of another commit's sources:

    python -m msla_tpu_torch.tools.bench_stems [--previous DIR]     # on the card

- "kernel": the sources as they are, the wrappers' kernels (checked equal to
  the wrappers' outputs bit for bit, and to the plain versions: the stems at
  atol = rtol = 1e-4, each id of K3, #4, #8 and #9 equal or a near-tie on its
  own distance, #4's q equal to codebook[id]);
- "no split": ``tf32_split.cuh``'s split() without its arithmetic (hi = lo =
  x), the same products on unsplit operands: the split's ALU work is the
  difference (its sums are wrong and not checked); not for #9, which has no
  TF32 split;
- "one product": ``mma_3xtf32`` as hi·hi alone, one-pass TF32: what the
  second and third products cost (not checked either; not for #9);
- "A streamed" (K3, #4, #8): ``vq_search.cuh`` with ``kHoldA`` false, the A
  fragments loaded and split from the x tile for each group of codes instead
  of held in registers for the tile (checked as "kernel");
- "no fold" (#9): the products without the fold of their distances into the
  running minimum (the ids are wrong and not checked);
- "no q" (#9): everything but the stores of q (not checked);
- "stream only" (#5, #9 split2): ``segment_sum.cuh`` without the calls of
  ``sort_stage``, ``walk`` and ``add_group``: the TMA ring of rows and ids
  with its barriers and turns, the clusters' sums and the last kernel, but
  no sort and no sums of rows: the stream's share of the time (not checked);
- "previous", with ``--previous DIR`` (another commit's
  ``msla_tpu_torch/csrc``, such as the parent's unpacked by ``git archive``):
  that commit's sources, checked as "kernel" is against the plain versions
  (the segment sums within 1e-5 of the largest |entry| of fp64's; "kernel"'s
  bit for bit against ``codebook_grad_order_ref`` at the card's grid). Its
  entry points must take the widths as these do (the fp32 stems' channels,
  the VQ kernels' D): a tree whose ``conv_stem.cu`` does not export
  ``conv_stem_smem_bytes`` is older and is refused.
Each build is compiled as ``ops/_build.py`` compiles the port's sources, one
nvcc each, in parallel, under build/bench_stems/. Its entry points run on the
same operands (the stems' weights as torch initialises the model's convs,
seed 0; x and the codebook standard normal, seed 0), K1 and K2 without and
with the hidden, #9 in each mode, in turns: every build once, then again in
reverse order, each time the mean of ``ITERS`` launches between two CUDA
events. The VQ kernels' time is the kernel's alone: the wrappers' ‖e‖², bf16
split and allocations are made once, outside the loop. Prints the card's
name and power limit (nvidia-smi) and a line a build and kernel, and returns
the times by build, kernel and round.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.ops import (_build, conv_stem, conv_stem_ref, deconv_stem, deconv_stem_ref,
                                nearest_codes, nearest_codes_ref, segment_sum, vq_codebook_grad,
                                vq_fused_fwd, vq_lean_fwd, vq_precision_bwd, vq_precision_fwd,
                                vq_precision_fwd_ref)
from msla_tpu_torch.ops._build import check, stream_of
from msla_tpu_torch.ops.nearest_codes import code_norms
from msla_tpu_torch.ops.vq_fused import count_outputs
from msla_tpu_torch.ops.vq_precision import COMPILED, dotted_norms, split_bf16
from msla_tpu_torch.tools import loop_ms

BATCH, T = 64, 44_000          # a batch-64 separation or train step: 2 s frames at 22 kHz
N, K = BATCH * T // 4, 512     # the latent rows of such a batch, and the codes
ITERS = 20
OUT_DIR = _build.BUILD_DIR.parent / "bench_stems"
STEMS = ("conv_stem", "deconv_stem")
SEARCH = ("nearest_codes", "vq_fused", "vq_lean")
TF32 = STEMS + SEARCH           # the 3xTF32 sources, which the TF32 probes edit
SOURCES = TF32 + ("vq_precision",)
#: the fp32 stems' widths their entry points take: (C1, C2) and (C, C1)
WIDTHS = {"conv_stem": (64, 128), "deconv_stem": (128, 64)}
ENTRY = {"conv_stem": "conv_stem_fwd", "deconv_stem": "deconv_stem_fwd",
         "nearest_codes": "nearest_codes_fwd", "vq_fused": "vq_fused_fwd",
         "vq_lean": "vq_lean_fwd", "vq_precision": "vq_precision_fwd"}

#: the probes' edits: (header, its (text, replacement) pairs, the sources they
#: are built for)
PROBES = {
    "no split": ("tf32_split.cuh",
                 (("  const float f = __uint_as_float(x);\n  hi = tf32(f);\n"
                   "  lo = tf32(f - __uint_as_float(hi));\n", "  hi = x;\n  lo = x;\n"),), TF32),
    "one product": ("tf32_split.cuh",
                    (("  mma_tf32(c, al, bh0, bh1);\n  mma_tf32(c, ah, bl0, bl1);\n", ""),), TF32),
    "A streamed": ("vq_search.cuh",
                   (("constexpr bool kHoldA = D <= 64;", "constexpr bool kHoldA = false;"),),
                   SEARCH),
    "no fold": ("vq_precision.cu",
                (("      mlm::fold_tile<false>(d", "      if (0) mlm::fold_tile<false>(d"),),
                ("vq_precision",)),
    "no q": ("vq_precision.cu", (("    if (row < n) q4[row * (D / 4) + l] = e;\n", ""),),
             ("vq_precision",)),
    "stream only": ("segment_sum.cuh",
                    (("      sort_stage<SPLIT2>(", "      if (0) sort_stage<SPLIT2>("),
                     ("        walk<SPLIT2>(", "        if (0) walk<SPLIT2>("),
                     ("        add_group(", "        if (0) add_group(")),
                    ("vq_fused", "vq_precision")),
}
#: the segment sums' entry points by source: (label, symbol, split2)
SEGMENT_SUMS = {"vq_fused": ("#5", "vq_codebook_grad", False),
                "vq_precision": ("#9 split2", "vq_precision_bwd_split2", True)}
SEGMENT_BUILDS = ("kernel", "previous", "stream only")  # the builds that time them


def _sources(name: str, csrc: Path) -> Path:
    """A build's sources in OUT_DIR/<name>: csrc's, with a probe's edit."""
    dst = OUT_DIR / name.replace(" ", "_")
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for f in [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]:
        shutil.copy(f, dst)
    if name in PROBES:
        header, edits, _ = PROBES[name]
        path = dst / header
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"bench_stems: {header} no longer holds the code the "
                                   f"{name!r} probe edits, once")
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def build(builds: dict[str, Path]) -> dict[tuple[str, str], ctypes.CDLL]:
    """Each build's libraries of its sources, all compiled at once."""
    jobs = {}
    for name, src in builds.items():
        for source in PROBES[name][2] if name in PROBES else SOURCES:
            lib = src / f"{source}.so"
            jobs[name, source] = lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, source), (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"bench_stems: {name} {source}.cu did not build:\n{log}")
        if name in ("kernel", *PROBES):
            print(f"[bench_stems] {name} {source}.cu ptxas:\n" + "\n".join(
                line for line in log.splitlines() if "registers" in line or "spill" in line),
                flush=True)
        libs[name, source] = ctypes.CDLL(str(lib))
    return libs


def entry(lib: ctypes.CDLL, symbol: str) -> ctypes._CFuncPtr:
    fn = getattr(lib, symbol)
    fn.argtypes = _build.SIGNATURES[symbol][1]
    fn.restype = ctypes.c_int
    return fn


def segment_sum_cases(name: str, lib: ctypes.CDLL, source: str, g: torch.Tensor, ids: dict):
    """(kernel label, launch, check) of a build's segment sum on each kind of
    ids, through its entry point (#5's at D = 64)."""
    label, symbol, split2 = SEGMENT_SUMS[source]
    dev, n = g.device, g.shape[0]
    dcb = torch.empty((K, 64), device=dev)
    fp64 = {kind: segment_sum.segment_sum_fp64(g, i, K, split2) for kind, i in ids.items()}
    fn = entry(lib, symbol)
    clusters, rows = segment_sum.launch_layout(symbol, n, K, dev, split2)
    partials = torch.empty((clusters, 1 + split2, K, 64), device=dev)
    args = (clusters, rows, n, K) if split2 else (clusters, rows, n, K, 64)
    wrapper = vq_codebook_grad if not split2 else (
        lambda g, i, k: vq_precision_bwd(g, i, "split2", k))
    for kind, i in ids.items():
        def run(i=i):
            check(name, fn(g.data_ptr(), i.data_ptr(), dcb.data_ptr(), partials.data_ptr(),
                           *args, stream_of(g)))

        def verify(i=i, kind=kind):
            err = (dcb.double() - fp64[kind]).abs().max().item()
            if err > 1e-5 * fp64[kind].abs().max().item():
                raise RuntimeError(f"bench_stems: {name} {label} on {kind} ids: max abs "
                                   f"error {err:.3e} against fp64")
            if name == "kernel":
                blocks = args[0] * segment_sum.CLUSTER
                want = segment_sum.codebook_grad_order_ref(g, i, K, blocks, split2=split2)
                if not (torch.equal(dcb, want) and torch.equal(dcb, wrapper(g, i, K))):
                    raise RuntimeError(f"bench_stems: the {source} build's {label} differs "
                                       f"from the wrapper's kernel or from its order")

        yield f"{label} {kind}", run, verify


def operands(dev: torch.device):
    """K1's (x, w1, b1, w2, b2), K2's (q, ...), fp32, seed 0; and the search's
    (x, codebook)."""
    torch.manual_seed(0)
    enc = (torch.nn.Conv1d(4, 64, 4, device=dev), torch.nn.Conv1d(64, 128, 4, device=dev))
    dec = (torch.nn.ConvTranspose1d(128, 64, 4, device=dev),
           torch.nn.ConvTranspose1d(64, 4, 4, device=dev))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((BATCH, 4, T), generator=g, device=dev) * 0.3
    q = torch.rand((BATCH, 128, T // 4), generator=g, device=dev)
    flat = torch.randn((N, 64), generator=g, device=dev)
    cb = torch.randn((K, 64), generator=g, device=dev)
    weights = lambda convs: (convs[0].weight.detach(), convs[0].bias.detach(),
                             convs[1].weight.detach(), convs[1].bias.detach())
    return (x, *weights(enc)), (q, *weights(dec)), (flat, cb)


def check_ids(what: str, ids: torch.Tensor, want: torch.Tensor, flat, cb,
              dist_mode: str = "f32") -> None:
    """Every id equal to the plain version's or a near-tie: the two picks'
    fp64 dists within 1e-5 of |dist| + 1 (chip_smoke.py's rule), on the
    operands of #9's ``dist_mode`` (the fp32 ones for "f32")."""
    ids, want = ids.flatten(), want.flatten()
    rows = (ids != want).nonzero().flatten()
    if rows.numel():
        x, e = flat[rows].double(), cb.double()
        (xh, xl), (eh, el) = ([t.double() for t in split_bf16(v)] for v in (flat[rows], cb))

        def dist(i):
            if dist_mode == "f32":
                return (e[i] * e[i]).sum(1) - 2 * (x * e[i]).sum(1)
            if dist_mode == "bf16":
                return (eh[i] * eh[i]).sum(1) - 2 * (xh * eh[i]).sum(1)
            full = eh[i] + el[i]
            return (full * full).sum(1) - 2 * (xh * eh[i] + xh * el[i] + xl * eh[i]).sum(1)

        a, b = dist(ids[rows].long()), dist(want[rows].long())
        if ((a - b).abs() / (b.abs() + 1)).max().item() >= 1e-5:
            raise RuntimeError(f"bench_stems: {what}: an id is neither the plain one nor a "
                               f"near-tie")


def main(previous: str | None = None, device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bench_stems times CUDA builds: it needs the card")
    csrc = _build.CSRC
    builds = {name: _sources(name, csrc) for name in ("kernel", *PROBES)}
    if previous is not None:
        builds["previous"] = _sources("previous", Path(previous))
    libs = build(builds)
    if previous is not None and not hasattr(libs["previous", "conv_stem"], "conv_stem_smem_bytes"):
        raise ValueError(f"bench_stems: {previous} holds kernels whose entry points do not take "
                         f"the widths (no conv_stem_smem_bytes); compare with a later tree")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    k1, k2, (flat, cb) = operands(dev)
    with torch.no_grad():
        plain = {"conv_stem": conv_stem_ref(*k1)[0], "deconv_stem": deconv_stem_ref(*k2)[0]}
        wrapper = {"conv_stem": conv_stem(*k1), "deconv_stem": deconv_stem(*k2)}
        plain_ids = nearest_codes_ref(flat, cb)
        wrapper_ids = nearest_codes(flat, cb)
        wrapper_fused = vq_fused_fwd(flat, cb)
        wrapper_lean = vq_lean_fwd(flat, cb)
        modes = [(f"{d}/{q}", d, q) for d, q in COMPILED]
        wrapper_prec = {m: vq_precision_fwd(flat, cb, d, q) for m, d, q in modes}
        plain_prec = {m: vq_precision_fwd_ref(flat, cb, d, q)[1] for m, d, q in modes}
    x, w1, b1, w2, b2 = k1
    args = {"conv_stem": (x, w1.permute(1, 2, 0).contiguous(), b1,  # the wrapper's layout
                          w2.permute(1, 2, 0).contiguous(), b2),
            "deconv_stem": k2}
    hidden = {"conv_stem": (BATCH, 64, T // 2), "deconv_stem": (BATCH, 64, T // 2)}
    e2 = code_norms(cb)
    counts, sq, counts_i, sq_part, parts = count_outputs(K, dev)
    hi, lo = split_bf16(cb)
    checked = ("kernel", "previous", "A streamed")
    grad = torch.randn((N, 64), generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    grad_ids = {"uniform": torch.randint(0, K, (N,), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev, dtype=torch.int32),
        "one code": torch.full((N,), 7, device=dev, dtype=torch.int32)}

    def cases(name: str, source: str):
        """(kernel label, launch, check after the first launch) of a build's source."""
        if name in SEGMENT_BUILDS and source in SEGMENT_SUMS:
            yield from segment_sum_cases(name, libs[name, source], source, grad, grad_ids)
        if name == "stream only":
            return
        fn = entry(libs[name, source], ENTRY[source])
        if source in STEMS:
            for with_hidden in (False, True):
                a = args[source]
                out = torch.empty(plain[source].shape, device=dev)  # contiguous
                h = torch.empty(hidden[source], device=dev) if with_hidden else None

                def run(fn=fn, a=a, out=out, h=h):
                    check(name, fn(*(t.data_ptr() for t in a), out.data_ptr(),
                                   None if h is None else h.data_ptr(), BATCH, a[0].shape[-1],
                                   *WIDTHS[source], stream_of(a[0])))

                def verify(out=out, source=source):
                    if name == "kernel" and not torch.equal(out, wrapper[source]):
                        raise RuntimeError(f"bench_stems: the {source} build differs from "
                                           f"the wrapper's kernel")
                    torch.testing.assert_close(out, plain[source], atol=1e-4, rtol=1e-4)

                label = {"conv_stem": "K1", "deconv_stem": "K2"}[source] + \
                    ("b" if with_hidden else "")
                yield label, run, verify
        elif source == "nearest_codes":
            ids = torch.empty((N,), dtype=torch.int32, device=dev)

            def run(fn=fn):
                check(name, fn(flat.data_ptr(), cb.data_ptr(), e2.data_ptr(), ids.data_ptr(), N,
                               K, 64, stream_of(flat)))

            def verify():
                if name == "kernel" and not torch.equal(ids, wrapper_ids):
                    raise RuntimeError("bench_stems: the nearest_codes build differs from the "
                                       "wrapper's kernel")
                check_ids(f"{name} K3", ids, plain_ids, flat, cb)

            yield "K3", run, verify
        elif source == "vq_lean":
            ids = torch.empty((N,), dtype=torch.int32, device=dev)

            def run(fn=fn):
                check(name, fn(flat.data_ptr(), cb.data_ptr(), e2.data_ptr(), ids.data_ptr(),
                               counts.data_ptr(), sq.data_ptr(), counts_i.data_ptr(),
                               sq_part.data_ptr(), parts, N, K, stream_of(flat)))

            def verify():
                if name == "kernel" and not all(torch.equal(a, b) for a, b in zip(
                        (ids, counts, sq), wrapper_lean[1:])):
                    raise RuntimeError("bench_stems: the vq_lean build differs from the "
                                       "wrapper's kernel")
                check_ids(f"{name} #8", ids, plain_ids, flat, cb)

            yield "#8", run, verify
        elif source == "vq_precision":
            for mode, dist_mode, quant_mode in modes:
                q = torch.empty((N, 64), device=dev)
                ids = torch.empty((N,), dtype=torch.int32, device=dev)
                e2m = dotted_norms(hi, lo, dist_mode)

                def run(fn=fn, q=q, ids=ids, e2m=e2m, codes=COMPILED[dist_mode, quant_mode]):
                    check(name, fn(*codes, flat.data_ptr(), cb.data_ptr(), hi.data_ptr(),
                                   lo.data_ptr(), e2m.data_ptr(), q.data_ptr(), ids.data_ptr(),
                                   counts.data_ptr(), sq.data_ptr(), counts_i.data_ptr(),
                                   sq_part.data_ptr(), parts, N, K, stream_of(flat)))

                def verify(q=q, ids=ids, mode=mode, dist_mode=dist_mode):
                    got = (q, ids[:, None], counts[None], sq.reshape(1, 1))
                    if name == "kernel" and not all(torch.equal(a, b) for a, b in zip(
                            got, wrapper_prec[mode])):
                        raise RuntimeError(f"bench_stems: the vq_precision build differs from "
                                           f"the wrapper's kernel in {mode}")
                    check_ids(f"{name} #9 {mode}", ids, plain_prec[mode], flat, cb, dist_mode)

                yield f"#9 {mode}", run, verify
        else:
            q = torch.empty((N, 64), device=dev)
            ids = torch.empty((N,), dtype=torch.int32, device=dev)

            def run(fn=fn):
                check(name, fn(flat.data_ptr(), cb.data_ptr(), e2.data_ptr(), q.data_ptr(),
                               ids.data_ptr(), counts.data_ptr(), sq.data_ptr(),
                               counts_i.data_ptr(), sq_part.data_ptr(), parts, N, K, 64,
                               stream_of(flat)))

            def verify():
                if name == "kernel" and not all(torch.equal(a, b) for a, b in zip(
                        (q, ids, counts, sq), wrapper_fused)):
                    raise RuntimeError("bench_stems: the vq_fused build differs from the "
                                       "wrapper's kernel")
                if not torch.equal(q, cb[ids.long()]):
                    raise RuntimeError(f"bench_stems: {name} #4: q is not codebook[id]")
                check_ids(f"{name} #4", ids, plain_ids, flat, cb)

            yield "#4", run, verify

    times: dict[str, dict[str, list[float]]] = {}
    for rnd, order in enumerate((list(builds), list(builds)[::-1])):
        for name in order:
            for source in PROBES[name][2] if name in PROBES else SOURCES:
                for kernel, run, verify in cases(name, source):
                    run()
                    torch.cuda.synchronize()
                    if rnd == 0 and name in checked:
                        verify()
                    ms = loop_ms(run, dev, ITERS)
                    times.setdefault(name, {}).setdefault(kernel, []).append(ms)
                    print(f"[bench_stems] round {rnd} {name:<12s} {kernel:<16s} {ms:.4f} ms",
                          flush=True)
    return times


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--previous", metavar="DIR",
                        help="another commit's msla_tpu_torch/csrc, timed beside these")
    print(main(parser.parse_args().previous))
