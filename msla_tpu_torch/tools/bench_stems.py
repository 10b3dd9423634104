"""Where the fp32 stems' time goes: their kernels (K1/K1b ``csrc/conv_stem.cu``,
K2/K2b ``csrc/deconv_stem.cu``, 3xTF32 on the tensor cores) timed on the card
at a batch-64 call's shapes, beside builds of the same sources with part of
the work taken out, and of another commit's sources:

    python -m msla_tpu_torch.tools.bench_stems [--previous DIR]     # on the card

- "kernel": the sources as they are, the wrappers' kernels (checked equal to
  the wrappers' outputs bit for bit, and to the plain versions at atol = rtol
  = 1e-4);
- "no split": ``tf32_split.cuh``'s split() without its arithmetic (hi = lo =
  x), the same products on unsplit operands: the split's ALU work is the
  difference (its sums are wrong and not checked);
- "one product": ``mma_3xtf32`` as hi·hi alone, one-pass TF32: what the
  second and third products cost (not checked either);
- "previous", with ``--previous DIR`` (another commit's
  ``msla_tpu_torch/csrc``, such as the parent's unpacked by ``git archive``):
  that commit's conv_stem.cu and deconv_stem.cu, checked against the plain
  versions at atol = rtol = 1e-4.
Each build is compiled as ``ops/_build.py`` compiles the port's sources, one
nvcc each, in parallel, under build/bench_stems/. Its fp32 entry points run
on the same operands (the stems' weights as torch initialises the model's
convs, seed 0), K1 and K2 without and with the hidden, in turns: every build
once, then again in reverse order, each time the mean of ``ITERS`` launches
between two CUDA events. Prints the card's name and power limit (nvidia-smi)
and a line a build and kernel, and returns the times by build, kernel and
round.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.ops import _build, conv_stem, conv_stem_ref, deconv_stem, deconv_stem_ref
from msla_tpu_torch.ops._build import check, stream_of
from msla_tpu_torch.tools import loop_ms

BATCH, T = 64, 44_000          # a batch-64 separation or train step: 2 s frames at 22 kHz
ITERS = 20
OUT_DIR = _build.BUILD_DIR.parent / "bench_stems"
SOURCES = ("conv_stem", "deconv_stem")

#: the probes' edits of tf32_split.cuh: (text, replacement)
PROBES = {
    "no split": ("  const float f = __uint_as_float(x);\n  hi = tf32(f);\n"
                 "  lo = tf32(f - __uint_as_float(hi));\n", "  hi = x;\n  lo = x;\n"),
    "one product": ("  mma_tf32(c, al, bh0, bh1);\n  mma_tf32(c, ah, bl0, bl1);\n", ""),
}


def _sources(name: str, csrc: Path) -> Path:
    """A build's sources in OUT_DIR/<name>: csrc's, with a probe's edit."""
    dst = OUT_DIR / name.replace(" ", "_")
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for f in [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]:
        shutil.copy(f, dst)
    if name in PROBES:
        old, new = PROBES[name]
        header = dst / "tf32_split.cuh"
        text = header.read_text()
        if old not in text:
            raise RuntimeError(f"bench_stems: tf32_split.cuh no longer holds the code the "
                               f"{name!r} probe edits")
        header.write_text(text.replace(old, new))
    return dst


def build(builds: dict[str, Path]) -> dict[tuple[str, str], ctypes._CFuncPtr]:
    """Each build's conv_stem_fwd and deconv_stem_fwd, all compiled at once."""
    jobs = {}
    for name, src in builds.items():
        for source in SOURCES:
            lib = src / f"{source}.so"
            jobs[name, source] = lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for (name, source), (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"bench_stems: {name} {source}.cu did not build:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{source}_fwd")
        fn.argtypes, fn.restype = _build.SIGNATURES[f"{source}_fwd"][1], ctypes.c_int
        fns[name, source] = fn
    return fns


def operands(dev: torch.device):
    """K1's (x, w1, b1, w2, b2) and K2's (q, ...), fp32, seed 0."""
    torch.manual_seed(0)
    enc = (torch.nn.Conv1d(4, 64, 4, device=dev), torch.nn.Conv1d(64, 128, 4, device=dev))
    dec = (torch.nn.ConvTranspose1d(128, 64, 4, device=dev),
           torch.nn.ConvTranspose1d(64, 4, 4, device=dev))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((BATCH, 4, T), generator=g, device=dev) * 0.3
    q = torch.rand((BATCH, 128, T // 4), generator=g, device=dev)
    weights = lambda convs: (convs[0].weight.detach(), convs[0].bias.detach(),
                             convs[1].weight.detach(), convs[1].bias.detach())
    return (x, *weights(enc)), (q, *weights(dec))


def main(previous: str | None = None, device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bench_stems times CUDA builds: it needs the card")
    csrc = _build.CSRC
    builds = {name: _sources(name, csrc) for name in ("kernel", *PROBES)}
    if previous is not None:
        builds["previous"] = _sources("previous", Path(previous))
    fns = build(builds)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    k1, k2 = operands(dev)
    with torch.no_grad():
        plain = {"conv_stem": conv_stem_ref(*k1)[0], "deconv_stem": deconv_stem_ref(*k2)[0]}
        wrapper = {"conv_stem": conv_stem(*k1), "deconv_stem": deconv_stem(*k2)}
    x, w1, b1, w2, b2 = k1
    args = {"conv_stem": (x, w1.permute(1, 2, 0).contiguous(), b1,  # the wrapper's layout
                          w2.permute(1, 2, 0).contiguous(), b2),
            "deconv_stem": k2}
    hidden = {"conv_stem": (BATCH, 64, T // 2), "deconv_stem": (BATCH, 64, T // 2)}
    times: dict[str, dict[str, list[float]]] = {}
    for rnd, order in enumerate((list(builds), list(builds)[::-1])):
        for name in order:
            for source in SOURCES:
                for with_hidden in (False, True):
                    a = args[source]
                    out = torch.empty(plain[source].shape, device=dev)  # contiguous
                    h = torch.empty(hidden[source], device=dev) if with_hidden else None
                    run = lambda fn=fns[name, source], a=a, out=out, h=h: check(name, fn(
                        *(t.data_ptr() for t in a), out.data_ptr(),
                        None if h is None else h.data_ptr(), BATCH, a[0].shape[-1],
                        stream_of(a[0])))
                    run()
                    torch.cuda.synchronize()
                    if rnd == 0 and name == "kernel" and not torch.equal(out, wrapper[source]):
                        raise RuntimeError(f"bench_stems: the {source} build differs from "
                                           f"the wrapper's kernel")
                    if rnd == 0 and name in ("kernel", "previous"):
                        torch.testing.assert_close(out, plain[source], atol=1e-4, rtol=1e-4)
                    kernel = {"conv_stem": "K1", "deconv_stem": "K2"}[source] + \
                        ("b" if with_hidden else "")
                    ms = loop_ms(run, dev, ITERS)
                    times.setdefault(name, {}).setdefault(kernel, []).append(ms)
                    print(f"[bench_stems] round {rnd} {name:<12s} {kernel:<3s} {ms:.4f} ms",
                          flush=True)
    return times


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--previous", metavar="DIR",
                        help="another commit's msla_tpu_torch/csrc, timed beside these")
    print(main(parser.parse_args().previous))
