"""Polyphase resampling (the port's copy of msla_tpu/data/resample.py;
reference: torchaudio.functional.resample in src/data/dataset.py:151-153).

scipy's polyphase filter (Kaiser-windowed sinc) over the up/down ratio reduced
by their gcd: the plain version of the native resampler (``data/native.py``)
that the tests hold it against.
"""
from __future__ import annotations

from math import gcd

import numpy as np
from scipy.signal import resample_poly


def resample(audio: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Resample (..., samples) float audio from orig_freq to new_freq."""
    if orig_freq == new_freq:
        return np.asarray(audio, dtype=np.float32)
    g = gcd(int(orig_freq), int(new_freq))
    up, down = new_freq // g, orig_freq // g
    out = resample_poly(np.asarray(audio, dtype=np.float64), up, down, axis=-1)
    return out.astype(np.float32)
