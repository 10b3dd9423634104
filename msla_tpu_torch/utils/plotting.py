"""Plotting suite (port of msla_tpu/utils/plotting.py; reference:
src/utils/plotting.py:17-107).

The same four plots under the same file names in ``paths.plot_dir``: the
codebook in 2-D coloured by KMeans(k=4), each instrument's used codes over it,
the waveform and the mel spectrogram. The JAX module draws with matplotlib,
seaborn and scikit-learn, which the card's machine does not have, so this one
needs numpy alone: it writes the SVG itself (the spectrogram as an embedded
PNG), projects with the JAX module's fallback (rows normalised for cosine
geometry, then PCA by SVD; ``umap`` is not installed either) and clusters with
k-means++ and Lloyd's iterations, 10 seeded starts, the least inertia kept.
"""
from __future__ import annotations

import base64
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from msla_tpu_torch.ops.stft import amplitude_to_db, mel_spectrogram

INSTRUMENTS = ("bass", "drums", "guitar", "piano")
CLUSTER_COLOURS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728")
# viridis at 0, 1/8, ..., 1 (matplotlib's table), interpolated linearly between
VIRIDIS = np.array([[68, 1, 84], [71, 45, 123], [59, 82, 139], [44, 114, 142],
                    [33, 145, 140], [40, 174, 128], [94, 201, 98], [173, 220, 48],
                    [253, 231, 37]], np.float64)
WIDTH, HEIGHT, MARGIN = 800, 600, 60


def project_2d(values: np.ndarray) -> np.ndarray:
    """(N, D) → (N, 2): rows normalised to unit length, centred, projected on
    their two principal axes (each axis signed so its largest loading is
    positive, as scikit-learn's PCA signs it)."""
    values = np.asarray(values, np.float64)
    unit = values / np.maximum(np.linalg.norm(values, axis=1, keepdims=True), 1e-12)
    centred = unit - unit.mean(axis=0)
    _, _, vt = np.linalg.svd(centred, full_matrices=False)
    axes = vt[:2]
    axes *= np.sign(axes[np.arange(2), np.abs(axes).argmax(axis=1)])[:, None]
    return centred @ axes.T


def kmeans(points: np.ndarray, k: int = 4, seed: int = 14, n_init: int = 10,
           iters: int = 300) -> np.ndarray:
    """Cluster labels of (N, d) points: k-means++ starts from
    ``default_rng(seed)``, Lloyd's iterations until no label changes, the
    start with the least inertia kept."""
    points = np.asarray(points, np.float64)
    rng = np.random.default_rng(seed)
    best, best_inertia = None, np.inf
    for _ in range(n_init):
        centres = [points[rng.integers(len(points))]]
        for _ in range(1, k):
            d2 = ((points[:, None] - np.array(centres)[None]) ** 2).sum(-1).min(1)
            p = d2 / d2.sum() if d2.sum() > 0 else None
            centres.append(points[rng.choice(len(points), p=p)])
        centres = np.array(centres)
        labels = None
        for _ in range(iters):
            new = ((points[:, None] - centres[None]) ** 2).sum(-1).argmin(1)
            if labels is not None and np.array_equal(new, labels):
                break
            labels = new
            centres = np.array([points[labels == j].mean(0) if (labels == j).any()
                                else centres[j] for j in range(k)])
        inertia = ((points - centres[labels]) ** 2).sum()
        if inertia < best_inertia:
            best, best_inertia = labels, inertia
    return best


def _load_codebook_csv(path: str) -> np.ndarray:
    return np.atleast_2d(np.genfromtxt(path, delimiter=",", skip_header=1))


def _svg(out_path: Path, title: str, body: list[str]) -> None:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    head = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{WIDTH}" height="{HEIGHT}" '
            f'viewBox="0 0 {WIDTH} {HEIGHT}" font-family="sans-serif">'
            f'<rect width="{WIDTH}" height="{HEIGHT}" fill="white"/>'
            f'<text x="{WIDTH / 2}" y="30" text-anchor="middle" font-size="18">{title}</text>')
    out_path.write_text(head + "".join(body) + "</svg>\n")


def _axes(xlabel: str, ylabel: str) -> list[str]:
    x0, y0, x1, y1 = MARGIN, HEIGHT - MARGIN, WIDTH - MARGIN, MARGIN
    return [f'<rect x="{x0}" y="{y1}" width="{x1 - x0}" height="{y0 - y1}" fill="none" '
            'stroke="#444"/>',
            f'<text x="{WIDTH / 2}" y="{HEIGHT - 15}" text-anchor="middle">{xlabel}</text>',
            f'<text x="18" y="{HEIGHT / 2}" text-anchor="middle" '
            f'transform="rotate(-90 18 {HEIGHT / 2})">{ylabel}</text>']


def _to_canvas(xy: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    span = np.where(hi > lo, hi - lo, 1.0)
    u = (xy - lo) / span
    return np.stack([MARGIN + u[:, 0] * (WIDTH - 2 * MARGIN),
                     HEIGHT - MARGIN - u[:, 1] * (HEIGHT - 2 * MARGIN)], axis=1)


def _scatter(proj: np.ndarray, clusters: np.ndarray, title: str, out_path: Path,
             overlay: np.ndarray | None = None) -> None:
    lo, hi = proj.min(0), proj.max(0)
    body = _axes("", "")
    for (x, y), c in zip(_to_canvas(proj, lo, hi), clusters):
        body.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" '
                    f'fill="{CLUSTER_COLOURS[int(c) % len(CLUSTER_COLOURS)]}"/>')
    if overlay is not None and len(overlay):
        for x, y in _to_canvas(overlay, lo, hi):
            body.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" fill="yellow" '
                        'fill-opacity="0.5"/>')
    body.append(f'<text x="{WIDTH - MARGIN - 90}" y="{MARGIN + 18}">Clusters</text>')
    for j, colour in enumerate(CLUSTER_COLOURS):
        y = MARGIN + 36 + 18 * j
        body.append(f'<circle cx="{WIDTH - MARGIN - 84}" cy="{y - 5}" r="5" fill="{colour}"/>'
                    f'<text x="{WIDTH - MARGIN - 72}" y="{y}">{j}</text>')
    _svg(out_path, title, body)


def _png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → PNG bytes."""
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def viridis(u: np.ndarray) -> np.ndarray:
    """Values in [0, 1] → (..., 3) uint8 colours of the viridis map."""
    pos = np.clip(u, 0.0, 1.0) * (len(VIRIDIS) - 1)
    i = np.minimum(pos.astype(int), len(VIRIDIS) - 2)
    f = (pos - i)[..., None]
    return np.round(VIRIDIS[i] * (1 - f) + VIRIDIS[i + 1] * f).astype(np.uint8)


def plot_codebook(cfg) -> None:
    """Codebook in 2-D with KMeans(k=4) clusters (reference: plotting.py:17-30)."""
    proj = project_2d(_load_codebook_csv(str(cfg.paths.codebook_file)))
    _scatter(proj, kmeans(proj), "Codebook Embeddings - KMeans Clustering (k=4)",
             Path(str(cfg.paths.plot_dir)) / "codebook.svg")


@torch.no_grad()
def plot_embeddings_from_quantized(cfg, batch: Tuple, task) -> dict[str, np.ndarray]:
    """Each instrument's used codes over the projected codebook (reference:
    plotting.py:33-64), through ``task.get_quantized`` on the task's device.
    Returns each instrument's used code ids."""
    proj = project_2d(_load_codebook_csv(str(cfg.paths.codebook_file)))
    clusters = kmeans(proj)
    _, instruments = batch
    instruments = np.asarray(instruments)
    used_codes = {}
    for idx, name in enumerate(INSTRUMENTS):
        stem = instruments[:, idx, :].squeeze()
        one_instrument = torch.from_numpy(np.stack([stem] * 4)[None]).to(task.device)
        q = task.get_quantized(one_instrument)
        used = np.unique(q.encoding_indices.cpu().numpy())
        used_codes[name] = used
        _scatter(proj, clusters, f"{name.upper()} Embeddings",
                 Path(str(cfg.paths.plot_dir)) / f"{name}_embeddings_quantized_representation.svg",
                 overlay=proj[used[used < len(proj)]])
    return used_codes


def plot_waveform(waveform, plot_dir: str, sample_rate: int = 22050, title: str = None) -> None:
    """Waveform plot (reference: plotting.py:67-82): each channel as a
    polyline of its minimum and maximum in each of 1,000 time columns."""
    waveform = np.asarray(waveform, np.float64)
    if waveform.ndim == 1:
        waveform = waveform[None]
    n = waveform.shape[-1]
    cols = np.array_split(np.arange(n), min(n, 1000))
    duration = n / sample_rate
    lo, hi = np.array([0.0, min(waveform.min(), 0.0)]), np.array([duration, waveform.max()])
    body = _axes("Time (s)", "Amplitude")
    for channel in waveform:
        pts = []
        for c in cols:
            t = c[0] / sample_rate
            pts += [(t, channel[c].min()), (t, channel[c].max())]
        xy = _to_canvas(np.array(pts), lo, hi)
        body.append('<polyline fill="none" stroke="#1f77b4" stroke-width="1" points="'
                    + " ".join(f"{x:.1f},{y:.1f}" for x, y in xy) + '"/>')
    body.append(f'<text x="{WIDTH - MARGIN}" y="{HEIGHT - MARGIN + 18}" '
                f'text-anchor="end">{duration:.2f}</text>')
    _svg(Path(plot_dir) / f"{title}_waveform.svg", f"{title} Waveform", body)


def plot_spectrogram(waveform, plot_dir: str, sample_rate: int = 22050,
                     title: str = None) -> None:
    """Mel spectrogram, n_mels=128, dB scale (reference: plotting.py:85-106),
    low frequencies at the bottom."""
    waveform = torch.as_tensor(np.asarray(waveform, np.float32))
    if waveform.ndim == 1:
        waveform = waveform[None]
    mel = mel_spectrogram(waveform, sample_rate=sample_rate, n_fft=400, hop_length=160,
                          n_mels=128)
    mel_db = amplitude_to_db(mel)[0].numpy()[::-1]
    lo, hi = float(mel_db.min()), float(mel_db.max())
    png = _png(viridis((mel_db - lo) / max(hi - lo, 1e-12)))
    x0, y0, w, h = MARGIN, MARGIN, WIDTH - 2 * MARGIN - 60, HEIGHT - 2 * MARGIN
    body = _axes("Time", "Mel Filterbanks")
    body.append(f'<image x="{x0}" y="{y0}" width="{w}" height="{h}" preserveAspectRatio="none" '
                f'href="data:image/png;base64,{base64.b64encode(png).decode()}"/>')
    bar = _png(viridis(np.linspace(1.0, 0.0, 64))[:, None, :])
    body.append(f'<image x="{x0 + w + 15}" y="{y0}" width="15" height="{h}" '
                f'preserveAspectRatio="none" href="data:image/png;base64,'
                f'{base64.b64encode(bar).decode()}"/>'
                f'<text x="{x0 + w + 35}" y="{y0 + 10}">{hi:+.0f} dB</text>'
                f'<text x="{x0 + w + 35}" y="{y0 + h}">{lo:+.0f} dB</text>')
    _svg(Path(plot_dir) / f"{title}_spectrogram.svg", f"{title} Spectrogram", body)
