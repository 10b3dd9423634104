"""Tree-structured Parzen Estimator sampler (the port's copy of
msla_tpu/sweep/sampler.py, which stands in for optuna's TPESampler as
configs/hparams_search/optuna.yaml configures it: a seed and
``n_startup_trials``).

Random draws for the first ``n_startup_trials``; then the observations split
into the gamma-best ("good") and the rest ("bad"), candidates come from a
Parzen estimator over the good set, and the one that maximises l(x)/g(x) is
taken. Uniform ranges are modelled with a Gaussian a good observation
(bandwidth range / sqrt(n)), choices with smoothed counts. Every draw comes
from one ``numpy.random.default_rng(seed)`` in the JAX sampler's order, so
the same seed, space and observations give the same suggestions bit for bit.
"""
from __future__ import annotations

import numpy as np

from msla_tpu_torch.sweep.space import Categorical, Uniform


class TPESampler:
    def __init__(self, seed: int = 0, n_startup_trials: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24):
        self._rng = np.random.default_rng(seed)
        self.n_startup_trials = int(n_startup_trials)
        self.gamma = float(gamma)
        self.n_candidates = int(n_candidates)

    def sample(self, space: dict, observations: list[tuple[dict, float]]) -> dict:
        """The next trial's params; ``observations`` are (params, objective)
        pairs, lower better (the sweeper signs them for its direction)."""
        if len(observations) < self.n_startup_trials:
            return {name: dist.sample(self._rng) for name, dist in space.items()}

        ordered = sorted(observations, key=lambda t: t[1])
        n_good = max(1, int(np.ceil(self.gamma * len(ordered))))
        good = [p for p, _ in ordered[:n_good]]
        bad = [p for p, _ in ordered[n_good:]] or good

        out = {}
        for name, dist in space.items():
            good_vals = [g[name] for g in good]
            bad_vals = [b[name] for b in bad]
            if isinstance(dist, Uniform):
                out[name] = self._sample_uniform(dist, good_vals, bad_vals)
            elif isinstance(dist, Categorical):
                out[name] = self._sample_categorical(dist, good_vals, bad_vals)
            else:
                out[name] = dist.sample(self._rng)
        return out

    @staticmethod
    def _kde_logpdf(x: np.ndarray, obs: np.ndarray, low: float, high: float) -> np.ndarray:
        bw = max((high - low) / max(np.sqrt(len(obs)), 1.0), 1e-12)
        diff = (x[:, None] - obs[None, :]) / bw
        log_k = -0.5 * diff ** 2 - 0.5 * np.log(2 * np.pi) - np.log(bw)
        return np.logaddexp.reduce(log_k, axis=1) - np.log(len(obs))

    def _sample_uniform(self, dist: Uniform, good_vals, bad_vals) -> float:
        good = np.asarray(good_vals, dtype=float)
        bad = np.asarray(bad_vals, dtype=float)
        bw = max((dist.high - dist.low) / max(np.sqrt(len(good)), 1.0), 1e-12)
        centers = good[self._rng.integers(0, len(good), self.n_candidates)]
        cands = np.clip(centers + self._rng.normal(0, bw, self.n_candidates),
                        dist.low, dist.high)
        score = (self._kde_logpdf(cands, good, dist.low, dist.high)
                 - self._kde_logpdf(cands, bad, dist.low, dist.high))
        value = float(cands[int(np.argmax(score))])
        return int(round(value)) if dist.integer else value

    def _sample_categorical(self, dist: Categorical, good_vals, bad_vals):
        def probs(vals):
            counts = np.ones(len(dist.choices))  # +1 smoothing
            for v in vals:
                counts[dist.choices.index(v)] += 1
            return counts / counts.sum()

        score = probs(good_vals) / probs(bad_vals)
        return dist.choices[int(np.argmax(score * self._rng.uniform(0.5, 1.0, len(score))))]
