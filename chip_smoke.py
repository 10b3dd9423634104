#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (msla_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when its check fails:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the three CUDA kernels from msla_tpu_torch/csrc with nvcc, in parallel;
  3. each kernel against its plain PyTorch version on the card, at the shapes
     of a batch-64 separation (stems at atol = rtol = 1e-4; every nearest-code
     mismatch must be a near-tie), with median times over 20 CUDA-event-timed
     runs of the kernel, its plain version and one library call;
  4. the main path through the user's entry points: the full-width VQ-VAE
     (configs/model/vqvae.yaml) with seeded random weights,
     SourceSeparator.separate (plain and overlap) and encode_codes on a 60 s
     22 kHz mixture, and a timed batch-64 separation; every kernel's launch
     count must grow and every output be finite;
  5. the card against the port on the CPU (plain versions) on 2 frames;
  6. one JSON line with every kernel's numbers, then the device line.
It exits non-zero without a result when no CUDA card is present.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores (data sheet)
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
MODEL = dict(num_hidden=128, num_residual_layer=2, num_residual_hidden=32,
             num_embedding=512, embedding_dim=64, commitment_cost=0.25,
             learning_rate=1e-4, sample_rate=22000)
SR, FRAME, BATCH = 22000, 44000, 64   # configs/data/default.yaml: 22 kHz x 2 s, batch 64
SONG_S = 60.0                          # the separated song: 30 frames
HOST_RUNS = 20                         # timed batch-64 separations
STEM_TOL = 1e-4


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, each run between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    if (err > STEM_TOL + STEM_TOL * want.abs()).any():
        fail(f"{name}: max abs error {err.max().item():.3e} beyond atol=rtol={STEM_TOL}")
    return err.max().item()


def near_ties(x, codebook, idx_a, idx_b) -> tuple[int, float, float]:
    """Rows where two id vectors differ, and the largest fp64 distance gap between
    the two picks, absolute and relative to |dist|+1. Fails unless every relative
    gap is below 1e-5 (a near-tie that fp32 sums in another order may flip)."""
    rows = (idx_a != idx_b).nonzero().flatten()
    if rows.numel() == 0:
        return 0, 0.0, 0.0
    xs, cb = x[rows].double(), codebook.double()
    e2 = (cb * cb).sum(1)
    da = e2[idx_a[rows].long()] - 2 * (xs * cb[idx_a[rows].long()]).sum(1)
    db = e2[idx_b[rows].long()] - 2 * (xs * cb[idx_b[rows].long()]).sum(1)
    gap = (da - db).abs()
    rel = (gap / (db.abs() + 1)).max().item()
    if rel >= 1e-5:
        fail(f"nearest_codes: {rows.numel()} mismatches, one is not a near-tie "
             f"(relative gap {rel:.3e})")
    return rows.numel(), gap.max().item(), rel


def phase_kernels(net, dev) -> list[dict]:
    import torch.nn.functional as F

    from msla_tpu_torch.nn.layers import fp32_convs
    from msla_tpu_torch.ops import (conv_stem, conv_stem_ref, deconv_stem,
                                    deconv_stem_ref, nearest_codes, nearest_codes_ref)

    g = torch.Generator(device=dev).manual_seed(1)
    enc, dec = net.encoder, net.decoder
    w = FRAME // 4
    report = []
    with torch.no_grad():
        # K1 at the batch-64 encoder input
        x = torch.randn((BATCH, 4, FRAME), generator=g, device=dev) * 0.3
        args = (x, enc.conv1.weight, enc.conv1.bias, enc.conv2.weight, enc.conv2.bias)
        out = conv_stem(*args)
        torch.cuda.synchronize()
        err = check_close("conv_stem", out, conv_stem_ref(*args))
        with fp32_convs():
            lib = time_ms(lambda: F.relu(F.conv1d(F.relu(F.conv1d(x, args[1], args[2], 2, 1)),
                                                  args[3], args[4], 2, 1)))
        flops = 2 * BATCH * (FRAME // 2 * 64 * 4 * 4 + w * 128 * 64 * 4)
        report.append(dict(
            name="conv_stem", route="cuda", source="msla_tpu_torch/csrc/conv_stem.cu",
            replaces="msla_tpu/ops/conv_stem.py:48", max_abs_err=err,
            ms=time_ms(lambda: conv_stem(*args)), plain_ms=time_ms(lambda: conv_stem_ref(*args)),
            library_ms=lib, flop=flops, bytes=nbytes(*args, out)))
        del x, out

        # K2 at the batch-64 decoder stem input (post-ReLU activations)
        q = torch.rand((BATCH, 128, w), generator=g, device=dev)
        args = (q, dec.conv1_transpose.weight, dec.conv1_transpose.bias,
                dec.conv2_transpose.weight, dec.conv2_transpose.bias)
        out = deconv_stem(*args)
        torch.cuda.synchronize()
        err = check_close("deconv_stem", out, deconv_stem_ref(*args))
        with fp32_convs():
            lib = time_ms(lambda: F.conv_transpose1d(
                F.relu(F.conv_transpose1d(q, args[1], args[2], 2, 1)), args[3], args[4], 2, 1))
        flops = 2 * BATCH * (2 * w * 64 * 128 * 2 + 4 * w * 4 * 64 * 2)
        report.append(dict(
            name="deconv_stem", route="cuda", source="msla_tpu_torch/csrc/deconv_stem.cu",
            replaces="msla_tpu/ops/deconv_stem.py:35", max_abs_err=err,
            ms=time_ms(lambda: deconv_stem(*args)),
            plain_ms=time_ms(lambda: deconv_stem_ref(*args)),
            library_ms=lib, flop=flops, bytes=nbytes(*args, out)))
        del q, out

        # K3 at N = B*W rows against a 512 x 64 codebook
        n = BATCH * w
        flat = torch.randn((n, 64), generator=g, device=dev)
        cb = torch.randn((512, 64), generator=g, device=dev)
        idx = nearest_codes(flat, cb)
        want = nearest_codes_ref(flat, cb)
        torch.cuda.synchronize()
        # max_abs_err: the largest fp64 distance gap between the two picks
        mismatches, gap, rel_gap = near_ties(flat, cb, idx, want)
        e2 = (cb * cb).sum(1)
        lib = time_ms(lambda: torch.argmin(e2 - 2.0 * torch.matmul(flat, cb.T), dim=1))
        report.append(dict(
            name="nearest_codes", route="cuda", source="msla_tpu_torch/csrc/nearest_codes.cu",
            replaces="msla_tpu/ops/vq_pallas.py:40", max_abs_err=gap,
            index_mismatches=mismatches, max_tie_gap=rel_gap,
            ms=time_ms(lambda: nearest_codes(flat, cb)),
            plain_ms=time_ms(lambda: nearest_codes_ref(flat, cb)),
            library_ms=lib, flop=2 * n * 512 * 64, bytes=nbytes(flat, cb, idx)))
        del flat, cb, idx, want
    for k in report:
        k["bound_ms"], k["bound_by"] = bound(k["flop"], k["bytes"])
        print(f"[kernel] {k['name']}: max_abs_err={k['max_abs_err']:.3e} ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} library_ms={k['library_ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']})"
              + (f" mismatches={k['index_mismatches']} max_tie_gap={k['max_tie_gap']:.3e}"
                 if "index_mismatches" in k else ""), flush=True)
    return report


def synthetic_mixture(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    mix = sum(0.2 * np.sin(2 * np.pi * 55.0 * 2 ** i * (1 + 0.01 * rng.standard_normal()) * t)
              for i in range(4))
    return (mix + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def phase_main_path(task, kernels) -> dict:
    from msla_tpu_torch.inference import SourceSeparator

    for k in kernels:
        k.launches = 0
    song = synthetic_mixture(SONG_S, seed=2)
    sep = SourceSeparator(task, frame_samples=FRAME, batch_size=16)
    stems = sep.separate(song)
    stems_ov = sep.separate(song, overlap=True)
    codes = sep.encode_codes(song)
    for name, a, shape in (("separate", stems, (4, song.size)),
                           ("separate(overlap)", stems_ov, (4, song.size)),
                           ("encode_codes", codes, (-(-song.size // FRAME), FRAME // 4))):
        if a.shape != shape or not np.isfinite(a).all():
            fail(f"{name}: shape {a.shape} (want {shape}) or non-finite values")
    if codes.min() < 0 or codes.max() >= MODEL["num_embedding"]:
        fail("encode_codes: ids out of range")

    sep64 = SourceSeparator(task, frame_samples=FRAME, batch_size=BATCH)
    song64 = synthetic_mixture(BATCH * FRAME / SR, seed=3)
    sep64.separate(song64)                           # warm-up
    before = [k.launches for k in kernels]
    torch.cuda.reset_peak_memory_stats()
    host_s = []
    for _ in range(HOST_RUNS):
        t0 = time.perf_counter()
        out64 = sep64.separate(song64)
        host_s.append(time.perf_counter() - t0)
    per_batch = {k.__name__: (k.launches - b) // HOST_RUNS for k, b in zip(kernels, before)}
    if not np.isfinite(out64).all():
        fail("batch-64 separate: non-finite values")
    counts = {k.__name__: k.launches for k in kernels}
    if min(counts.values()) == 0:
        fail(f"a kernel of the main path never launched: {counts}")

    model_in = sep64._model_input(song64.reshape(BATCH, FRAME))
    device_ms = time_ms(lambda: sep64._separate(model_in), reps=10, warmup=2)
    q1, median, q3 = statistics.quantiles(host_s, n=4)
    result = dict(launches=counts, launches_per_batch64=per_batch,
                  batch64_host_s=dict(n=HOST_RUNS, median=median, q1=q1, q3=q3,
                                      min=min(host_s), max=max(host_s)),
                  batch64_device_ms=device_ms,
                  samples_per_s=BATCH * FRAME / median,
                  device_samples_per_s=BATCH * FRAME / (device_ms / 1e3),
                  device_busy_share=device_ms / 1e3 / median,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  breakdown_ms=breakdown(task.net, model_in))
    print(f"[main] launches={counts} per_batch64={per_batch} batch-64 separate: "
          f"{result['samples_per_s']:.0f} samples/s end to end (median of {HOST_RUNS}), "
          f"{result['device_samples_per_s']:.0f} samples/s on the device", flush=True)
    return result


def breakdown(net, x) -> dict:
    """Device ms of each layer of one batch-64 separation (CUDA events)."""
    from msla_tpu_torch.nn.layers import fp32_convs
    from msla_tpu_torch.ops import conv_stem, deconv_stem

    enc, dec, vq = net.encoder, net.decoder, net.vector_quantizer
    with torch.inference_mode(), fp32_convs():
        h = conv_stem(x, enc.conv1.weight, enc.conv1.bias, enc.conv2.weight, enc.conv2.bias)
        h2 = enc.conv3(h)
        z = net.conv(enc.residual_stack(h2)).transpose(1, 2).contiguous()
        q = vq(z).quantized_ste.transpose(1, 2).contiguous()
        d = dec.residual_stack(dec.conv1(q))
        parts = {
            "encoder_stem_kernel": lambda: conv_stem(x, enc.conv1.weight, enc.conv1.bias,
                                                     enc.conv2.weight, enc.conv2.bias),
            "encoder_conv3_residual": lambda: enc.residual_stack(enc.conv3(h)),
            "pre_vq_conv": lambda: net.conv(h2).transpose(1, 2).contiguous(),
            "vector_quantize": lambda: vq(z),
            "decoder_conv1_residual": lambda: dec.residual_stack(dec.conv1(q)),
            "decoder_stem_kernel": lambda: deconv_stem(
                d, dec.conv1_transpose.weight, dec.conv1_transpose.bias,
                dec.conv2_transpose.weight, dec.conv2_transpose.bias),
        }
        return {name: time_ms(fn, reps=10, warmup=2) for name, fn in parts.items()}


def phase_cpu_agreement(task) -> dict:
    from msla_tpu_torch.models.vqvae import VQVAETask

    cpu = VQVAETask(**MODEL, checkpoint_dir=".", codebook_file="codebook.csv", device="cpu")
    cpu.net.load_state_dict({k: v.cpu() for k, v in task.net.state_dict().items()})
    frames = synthetic_mixture(2 * FRAME / SR, seed=4).reshape(2, 1, FRAME).repeat(4, axis=1)
    x_cpu = torch.from_numpy(np.ascontiguousarray(frames))
    x_gpu = x_cpu.cuda()
    with torch.inference_mode():
        zg, zc = task.net.encode(x_gpu), cpu.net.encode(x_cpu)
        qg, qc = task.get_quantized(x_gpu), cpu.get_quantized(x_cpu)
        sg, sc = task.net.decode(qg.quantized).cpu(), cpu.net.decode(qc.quantized)
        ig, ic = qg.encoding_indices.cpu(), qc.encoding_indices
        agree = (ig == ic).double().mean().item()
        if agree < 0.999:
            fail(f"card vs CPU: only {agree:.5f} of codes agree")
        mismatches, _, gap = near_ties(zc.reshape(-1, zc.shape[-1]),
                                       cpu.net.vector_quantizer.codebook.weight,
                                       ig.flatten(), ic.flatten())
        z_err = (zg.cpu() - zc).abs().max().item()
        frame_ok = (ig == ic).all(dim=1)
        stem_err = 0.0
        if frame_ok.any():
            stem_err = check_close("separation card vs CPU", sc[frame_ok], sg[frame_ok])
        # the decoder alone on the same ids, whatever the lookup picked
        dec_err = check_close("decode_indices card vs CPU",
                              task.net.decode_indices(ic.cuda()).cpu(),
                              cpu.net.decode_indices(ic))
    result = dict(code_agreement=agree, code_mismatches=mismatches, max_tie_gap=gap,
                  latent_max_abs_err=z_err, frames_compared=int(frame_ok.sum()),
                  stem_max_abs_err=stem_err, decode_indices_max_abs_err=dec_err)
    print(f"[cpu-vs-card] {json.dumps(result)}", flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card and has no CPU mode",
              file=sys.stderr)
        return 2
    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.ops import KERNELS, _build

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on: the fp32 path would run in TF32")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.1f} s for {len(_build.SIGNATURES)} kernels", flush=True)

    dev = torch.device("cuda")
    task = VQVAETask(**MODEL, checkpoint_dir=".", codebook_file="codebook.csv", device=dev,
                     seed=0)

    # 3. kernels against their plain versions; 4. the main path; 5. CPU vs card
    report = phase_kernels(task.net, dev)
    main_path = phase_main_path(task, KERNELS)
    agreement = phase_cpu_agreement(task)

    for k in report:
        k["launches"] = main_path["launches"][k["name"]]
        k["launches_per_batch64"] = main_path["launches_per_batch64"][k["name"]]
    print(json.dumps({"card": smi, "build_s": build_s, "main_path": main_path,
                      "cpu_vs_card": agreement}), flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
