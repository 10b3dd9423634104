"""Slakh2100 dataset: offline clean + cache + frame index (the port's copy of
msla_tpu/data/dataset.py; reference: src/data/dataset.py:18-173).

Same pipeline semantics as the reference, host-side in numpy:

1. walk track directories; load the 4 stems (bass/drums/guitar/piano WAVs),
   resample to the target rate, trim 10 s from each end, cap at
   ``max_duration`` (floored to a whole number of frame durations);
2. skip tracks with <2 instruments or all-silence
   (silence test is ``int(sum) == 0`` — reference: dataset.py:99, kept verbatim);
3. cache each surviving track as ``tensor_{idx}.npy`` plus a JSON frame index
   ``dataset_dict.json`` with {file_path_idx, frame_start, frame_end};
4. frames are ``target_sample_duration``-second windows at a 1-second hop;
   silent and incomplete frames are skipped (reference: dataset.py:106-115).

The decode, resampling and frame scan run through the C++ IO library
(``data/native.py``), which raises when it cannot be built. The spectrogram
masking augmentation the reference applies per item on the CPU
(dataset.py:42-49) runs batched on the device in the train step
(``data/augment.py``).
``maximum_dataset_size`` is stored but (like the reference — SURVEY.md §2)
never enforced.
"""
from __future__ import annotations

import json
import logging
import os
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from msla_tpu_torch.data.native import frame_index, read_wav, resample
from msla_tpu_torch.data.wavio import write_wav

log = logging.getLogger(__name__)

STEM_NAMES = ("bass", "drums", "guitar", "piano")


class SlakhDataset:
    def __init__(self,
                 data_dir: str,
                 target_sample_duration: int,
                 target_sample_rate: int,
                 max_duration: int,
                 maximum_dataset_size: int,
                 masking: bool = False):
        """
        @param data_dir: path to the dataset directory
        @param target_sample_rate: sample rate at which to resample the songs
        @param target_sample_duration: duration in seconds of each batch sample
        @param max_duration: maximum duration in seconds of each song
        """
        self.data_dir = str(data_dir)
        self.save_file = os.path.join(self.data_dir, "dataset_dict.json")
        self.target_sample_duration = int(target_sample_duration)
        self.target_sample_rate = int(target_sample_rate)
        self.max_duration = int(max_duration)
        self.maximum_dataset_size = int(maximum_dataset_size)  # stored, not enforced (parity)
        self.masking = bool(masking)  # consumed by the on-device augment stage

        self.file_paths = sorted(
            os.path.join(self.data_dir, d) for d in os.listdir(self.data_dir)
            if os.path.isdir(os.path.join(self.data_dir, d)))

        if not os.path.isfile(self.save_file):
            self.clean_and_load()
        with open(self.save_file) as f:
            self.data_list = json.load(f)

        self.data_dict: dict[int, np.ndarray] = {}
        for elem in self.data_list:
            idx = elem["file_path_idx"]
            if idx not in self.data_dict:
                self.data_dict[idx] = np.load(f"{self.data_dir}/tensor_{idx}.npy")

    # ---- offline cleaning pass ---------------------------------------------
    def clean_and_load(self) -> None:
        log.info("Dataset cleaning: %s", self.data_dir)
        sr = self.target_sample_rate
        frame_len = sr * self.target_sample_duration

        data_list = []
        kept_paths = []
        for idx, _ in enumerate(self.file_paths):
            stems, num_instruments = self.get_stems(idx)

            if num_instruments < 2:
                log.info("Track %s with only one instrument", self.file_paths[idx])
                continue
            if int(stems.sum()) == 0:
                log.info("Track %s with only silence", self.file_paths[idx])
                continue

            kept_paths.append(self.file_paths[idx])
            with _replaced(f"{self.data_dir}/tensor_{idx}.npy") as f:
                np.save(f, stems)

            # non-silent, complete 1s-hop windows (native scan when built)
            for frame_start in frame_index(stems, sr, frame_len, self.max_duration):
                data_list.append({"file_path_idx": idx,
                                  "frame_start": int(frame_start),
                                  "frame_end": int(frame_start) + frame_len})

        self.file_paths = kept_paths
        with _replaced(self.save_file, "w") as f:
            json.dump(data_list, f)
        log.info("Finished dataset cleaning: %s", self.data_dir)

    def get_stems(self, idx: int) -> tuple[np.ndarray, int]:
        """Load the 4 instrument WAVs of one track → (4, N) float32, count present."""
        stems = []
        num_instruments = 0
        for name in STEM_NAMES:
            file_path = os.path.join(self.file_paths[idx], f"{name}.wav")
            if os.path.exists(file_path):
                audio, sr = read_wav(file_path)
                audio = resample(audio, sr, self.target_sample_rate)
                audio = self.cut(audio)
                stems.append(audio)
                num_instruments += 1
            else:
                stems.append(np.zeros((1, 1), dtype=np.float32))

        max_len = max(s.shape[-1] for s in stems)
        stems = [np.pad(s, ((0, 0), (0, max_len - s.shape[-1]))) for s in stems]
        out = np.stack(stems).squeeze(1).astype(np.float32)  # (4, 1, N) → (4, N)
        return out, num_instruments

    def cut(self, song: np.ndarray, trim: int = 10) -> np.ndarray:
        """Drop `trim` seconds from each end, cap at max_duration, floor to
        a whole number of frame durations (reference: dataset.py:155-163)."""
        sr = self.target_sample_rate
        song = song[:, sr * trim: song.shape[-1] - sr * trim]
        song_duration = song.shape[-1] // sr
        if song_duration > self.max_duration:
            return song[:, : self.max_duration * sr]
        new_duration = (song_duration // self.target_sample_duration) * self.target_sample_duration
        return song[:, : new_duration * sr]

    # ---- indexed access -----------------------------------------------------
    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, idx: int) -> np.ndarray:
        elem = self.data_list[idx]
        track = self.data_dict[elem["file_path_idx"]]
        return track[:, elem["frame_start"]: elem["frame_end"]]


@contextmanager
def _replaced(path: str, mode: str = "wb"):
    """A file written whole under another name, then renamed onto ``path``:
    the ranks of a data-parallel run clean a split at once, and each reads
    the cache only once it is complete."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, mode) as f:
        yield f
    os.replace(tmp, path)


def make_fixture_dataset(root: str | Path, n_tracks: int, seconds: float, sr: int,
                         seed: int = 0) -> Path:
    """Write tiny synthetic 4-stem tracks for tests/demos (SURVEY.md §4)."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    t = np.arange(int(sr * seconds)) / sr
    for i in range(n_tracks):
        track_dir = root / f"Track{i:05d}"
        track_dir.mkdir(exist_ok=True)
        for j, name in enumerate(STEM_NAMES):
            f0 = 55.0 * (2 ** j) * (1 + 0.02 * rng.standard_normal())
            # small DC offset keeps frame sums away from the reference's
            # int(sum)==0 silence test (dataset.py:111), which would otherwise
            # randomly drop zero-mean synthetic frames
            wave = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(t.shape) + 0.02
            write_wav(track_dir / f"{name}.wav", wave.astype(np.float32), sr)
    return root
