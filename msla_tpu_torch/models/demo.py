"""Audio demo of the first validation batch (port of msla_tpu/models/demo.py;
reference: vqvae.py:173-237).

Original against decoded WAVs per stem plus the mixed song, logged as a
5-column table. The caller runs the decoding forward first, outside any
guard, so a kernel that fails on the card raises (ROADMAP.md §3); only the
file writes and the loggers' table are guarded, as the reference's demo never
stops training.
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from msla_tpu_torch.data.wavio import write_wav

log = logging.getLogger(__name__)

INSTRUMENTS = ("bass", "drums", "guitar", "piano")
DEMO_COLUMNS = ["bass vs D(bass)", "drums vs D(drums)", "guitar vs D(guitar)",
                "piano vs D(piano)", "mixed vs D(mixed)"]


def log_audio_demo(trainer, checkpoint_dir: str, sample_rate: int, original: np.ndarray,
                   decoded: np.ndarray, task_name: str) -> None:
    """Write original/generated WAVs of one sample, (4, T) stems each, into
    ``checkpoint_dir`` and log the demo table to each of the trainer's loggers."""
    try:
        ckpt_dir = Path(checkpoint_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        data: list[list] = [[], []]
        for idx, name in enumerate(INSTRUMENTS):
            orig_file = ckpt_dir / f"original_{name}.wav"
            dec_file = ckpt_dir / f"generated_{name}.wav"
            write_wav(orig_file, original[idx], sample_rate)
            write_wav(dec_file, decoded[idx], sample_rate)
            data[0].append(str(orig_file))
            data[1].append(str(dec_file))
        orig_full = ckpt_dir / "original_full_song.wav"
        dec_full = ckpt_dir / "generated_full_song.wav"
        write_wav(orig_full, original.sum(axis=0), sample_rate)
        write_wav(dec_full, decoded.sum(axis=0), sample_rate)
        data[0].append(str(orig_full))
        data[1].append(str(dec_full))
        for lg in trainer.loggers:
            lg.log_table(f"DEMO EPOCH [{trainer.current_epoch}]", DEMO_COLUMNS, data)
    except Exception:  # a demo that cannot be written or logged must not stop training
        log.warning("Exception while executing -on validation batch end- during %s training",
                    task_name, exc_info=True)
