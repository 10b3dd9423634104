"""Inference paths (port of msla_tpu/inference.py).

* SourceSeparator: full-song separation. Frames the mixture into the training
  window, broadcasts it to the model's 4 input channels, runs encode → VQ →
  decode in fixed-size batches (pad rows fill the last batch, as the JAX
  package's one-compile bucket does), and stitches the frames back,
  optionally with a triangular cross-fade.
* AudioGenerator: Audio-BERT reconstruction of corrupted stems, and
  MaskGIT-style code sampling decoded through the VQ-VAE.
"""
from __future__ import annotations

import numpy as np
import torch

from msla_tpu_torch.models.bert import AudioBertTask
from msla_tpu_torch.models.vqvae import VQVAETask


class SourceSeparator:
    """Mixture waveform → per-stem waveforms through the trained VQ-VAE."""

    def __init__(self, task: VQVAETask, frame_samples: int, batch_size: int = 16):
        """``task``'s ``compute_dtype`` is the mode it serves in. Any frame
        length takes ``encode_codes`` (floor(F/4) codes a frame); ``separate``
        needs F divisible by 4 and, as the JAX package's, raises ValueError
        when it stitches the floor(F/4)·4 samples a frame gives back."""
        self.task = task
        self.frame_samples = int(frame_samples)
        self.batch_size = int(batch_size)

    def _model_input(self, frames: np.ndarray) -> torch.Tensor:
        """(B, F) frames → (B, 4, F) on the model's device."""
        x = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(self.task.device)
        return x[:, None, :].expand(-1, 4, -1).contiguous()

    @torch.inference_mode()
    def _separate(self, model_in: torch.Tensor) -> torch.Tensor:
        """(B, 4, F) → (B, 4, F): get_quantized → decode, the training
        forward's waveform without its losses."""
        net = self.task.net
        return net.decode(net.get_quantized(model_in).quantized)

    def separate(self, mixture: np.ndarray, overlap: bool = False) -> np.ndarray:
        """(T,) mixture → (4, T) stems. T is padded up to whole frames.

        overlap=True separates 50%-overlapped frames and cross-fades them with
        a triangular window, at 2× the compute.
        """
        mixture = np.asarray(mixture, np.float32).reshape(-1)
        t = mixture.shape[0]
        f = self.frame_samples
        hop = f // 2 if overlap else f
        n_frames = max(1, -(-max(t - f, 0) // hop) + 1)
        total = (n_frames - 1) * hop + f
        padded_sig = np.pad(mixture, (0, total - t))
        frames = np.stack([padded_sig[i * hop: i * hop + f] for i in range(n_frames)])

        out_frames = []
        for start in range(0, n_frames, self.batch_size):
            chunk = frames[start:start + self.batch_size]
            rows = chunk.shape[0]
            if rows < self.batch_size:  # fixed batch shape; pad rows dropped below
                chunk = np.pad(chunk, ((0, self.batch_size - rows), (0, 0)))
            stems = self._separate(self._model_input(chunk))
            out_frames.append(stems[:rows].cpu().numpy())
        sep = np.concatenate(out_frames, axis=0)  # (n_frames, 4, F)

        if not overlap:
            stems = sep.transpose(1, 0, 2).reshape(4, n_frames * f)
            return stems[:, :t]

        # triangular cross-fade overlap-add with weight normalization
        window = np.bartlett(f).astype(np.float32) + 1e-3
        out = np.zeros((4, total), np.float32)
        weight = np.zeros(total, np.float32)
        for i in range(n_frames):
            sl = slice(i * hop, i * hop + f)
            out[:, sl] += sep[i] * window
            weight[sl] += window
        return (out / weight).astype(np.float32)[:, :t]

    def encode_codes(self, mixture: np.ndarray) -> np.ndarray:
        """(T,) mixture → (n_frames, W) int32 codebook indices."""
        mixture = np.asarray(mixture, np.float32).reshape(-1)
        f = self.frame_samples
        n_frames = -(-mixture.shape[0] // f)
        padded = np.pad(mixture, (0, n_frames * f - mixture.shape[0])).reshape(n_frames, f)
        q = self.task.get_quantized(self._model_input(padded))
        return q.encoding_indices.cpu().numpy()


class AudioGenerator:
    """Audio-BERT reconstruction and MaskGIT-style code sampling over the
    VQ-VAE's codes (port of msla_tpu/inference.py::AudioGenerator). Noise and
    the sampler's jitter are drawn with numpy as the JAX package draws them,
    so one seed gives the same draws in both."""

    def __init__(self, bert_task: AudioBertTask, vqvae_task: VQVAETask):
        self.bert_task = bert_task
        self.vqvae_task = vqvae_task

    @torch.inference_mode()
    def corrupt_and_generate(self, stems: np.ndarray, corrupt_stem: int,
                             rng: np.random.Generator | None = None) -> np.ndarray:
        """The reference generate(): replace one stem with uniform noise,
        quantize through the frozen VQ-VAE, reconstruct through BERT.
        (B, 4, T) → (B, 4, T)."""
        rng = rng or np.random.default_rng()
        stems = np.asarray(stems, np.float32).copy()
        stems[:, corrupt_stem, :] = rng.random(stems.shape[-1], dtype=np.float32)
        x = torch.from_numpy(stems).to(self.vqvae_task.device)
        q = self.vqvae_task.get_quantized(x)
        out = self.bert_task.predict_step((q.encoding_indices, x))
        return out.cpu().numpy()

    @torch.inference_mode()
    def decode_codes(self, indices: np.ndarray) -> np.ndarray:
        """(B, W) code ids → (B, 4, T) stems through the VQ-VAE decoder."""
        ids = torch.as_tensor(np.asarray(indices), dtype=torch.int64,
                              device=self.vqvae_task.device)
        return self.vqvae_task.net.decode_indices(ids).cpu().numpy()

    def sample_codes(self, width: int, batch: int = 1, rounds: int = 4,
                     seed: int = 0, prompt: np.ndarray | None = None) -> np.ndarray:
        """Iterative masked code sampling: start from all-[MASK] (or a
        ``prompt`` with -1 at the unknown positions), run the Audio-BERT
        mapping, keep the most confident fraction of the unknown positions
        each round and re-mask the rest. Returns (B, width) code ids."""
        mask_id = self.bert_task.config.mask_token_id
        rng = np.random.default_rng(seed)
        codes = np.full((batch, width), -1, np.int64)
        if prompt is not None:
            codes[:, :] = prompt

        for r in range(rounds):
            unknown = codes < 0
            tokens = torch.from_numpy(np.where(unknown, mask_id, codes))
            proposal = self.bert_task.code_proposals(tokens).cpu().numpy()
            codes_new, confidence = proposal[..., 0].astype(np.int64), proposal[..., 1]
            if r == rounds - 1:
                codes = np.where(unknown, codes_new, codes)
                break
            keep_frac = (r + 1) / rounds
            for b in range(batch):
                unk_idx = np.flatnonzero(unknown[b])
                if unk_idx.size == 0:
                    continue
                order = np.argsort(-confidence[b, unk_idx]
                                   + 1e-6 * rng.standard_normal(unk_idx.size))
                n_keep = max(1, int(keep_frac * unk_idx.size))
                chosen = unk_idx[order[:n_keep]]
                codes[b, chosen] = codes_new[b, chosen]
        return codes.astype(np.int64)

    def generate_waveform(self, width: int, batch: int = 1, rounds: int = 4,
                          seed: int = 0) -> np.ndarray:
        """Sample codes and decode them to (B, 4, T) stems."""
        return self.decode_codes(self.sample_codes(width, batch=batch, rounds=rounds,
                                                   seed=seed))
