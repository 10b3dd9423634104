"""Argmax over the tied-decoder logits h·Eᵀ + b without the logits
(port of msla_tpu/ops/mlm_argmax.py).

On CUDA tensors ``mlm_argmax`` and ``mlm_argmax_conf`` launch the two variants
of the hand-written kernel ``csrc/mlm_argmax.cu``, which computes the logits
on the tensor cores in 3xTF32 and never writes them; on CPU tensors they run
``mlm_argmax_ref``, the JAX package's ``_mlm_argmax_jnp`` math in row chunks.
Ties go to the lowest index, as ``torch.argmax`` and ``jnp.argmax`` give them.
With bf16 h and E (the bf16 compute_dtype; the bias stays fp32) the logits
are the fp32 sums of the exact bf16 products, as the Pallas kernel takes them,
and the kernel runs one bf16 pass on the tensor cores.
``mlm_logits_3xtf32_ref`` emulates the kernel's arithmetic (``ops/tf32.py``),
and ``mlm_fold_tiled_ref`` the order in which the bf16 kernel folds the
logits, for the tests; no wrapper calls them.
"""
from __future__ import annotations

import collections

import torch

from msla_tpu_torch.ops._build import (check, count_launch, kernel, require, runs_plain,
                                       stream_of)
from msla_tpu_torch.ops.tf32 import product_3xtf32

#: the hidden width the CUDA kernel is compiled for (bert-base)
K = 768
_REF_ROWS = 4096   # rows per chunk of the plain version: 500 MB of logits at V = 30,522


def mlm_argmax_ref(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                   with_conf: bool = False):
    """Plain version on (M, K) rows: logits = h @ embᵀ + bias in fp32 (for
    bf16 h and emb, of the exact products), their argmax and, with
    ``with_conf``, exp(max − logsumexp)."""
    ids, conf = [], []
    e = emb.float()
    for chunk in h.split(_REF_ROWS):
        logits = chunk.float() @ e.T + bias
        ids.append(torch.argmax(logits, dim=-1).to(torch.int32))
        if with_conf:
            lse = torch.logsumexp(logits, dim=-1)
            conf.append(torch.exp(logits.max(dim=-1).values - lse))
    if not ids:  # no rows
        ids, conf = [h.new_empty((0,), dtype=torch.int32)], [h.new_empty((0,))]
    return (torch.cat(ids), torch.cat(conf)) if with_conf else torch.cat(ids)


def mlm_logits_3xtf32_ref(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor):
    """The CUDA kernel's logits on (M, K) rows, emulated with fp32 products of
    TF32 parts: each operand split as hi = tf32(x), lo = tf32(x − hi), and per
    8-deep step of the reduction lo_h·hi_E, hi_h·lo_E, then hi_h·hi_E added to
    one fp32 accumulator; the bias last. Each product of two TF32 parts is
    exact in fp32. The adds here round to nearest; the card's tensor cores
    accumulate more coarsely (``csrc/mlm_argmax.cu``), so this shows the
    split's arithmetic, not the accumulator's. For tests and
    ``chip_smoke.py``: (M, V) logits."""
    return product_3xtf32(h, emb.T) + bias


#: the kernel's vocab tile, and the columns of it that thread t of a row's
#: quad holds: 8j + 2t + e for j < 32, e < 2 (the m64n256 accumulator's)
TILE_N = 256
_THREAD_COLS = torch.tensor([[8 * j + 2 * t + e for j in range(32) for e in range(2)]
                             for t in range(4)])


def _combine(a: dict, b: dict, with_conf: bool) -> dict:
    """The kernel's ``combine`` of two partial results per row: the larger
    max, or on equal maxima the lower index; the sums rescaled to the max."""
    out = dict(a)
    if with_conf:
        mx = torch.maximum(a["m"], b["m"])
        sa = torch.where(a["m"] == -torch.inf, 0.0, a["s"] * torch.exp(a["m"] - mx))
        sb = torch.where(b["m"] == -torch.inf, 0.0, b["s"] * torch.exp(b["m"] - mx))
        out["s"] = sa + sb
    take = (b["m"] > a["m"]) | ((b["m"] == a["m"]) & (b["idx"] < a["idx"]))
    out["m"] = torch.where(take, b["m"], a["m"])
    out["idx"] = torch.where(take, b["idx"], a["idx"])
    return out


def mlm_fold_tiled_ref(logits: torch.Tensor, with_conf: bool = False):
    """The bf16 kernel's fold of (M, V) fp32 logits (bias included), emulated:
    the vocab in tiles of 256 columns, each row's 4 quad threads holding the
    columns ``_THREAD_COLS`` of every tile (columns past V are -inf) and
    folding them tile by tile in ascending order into a running (max, first
    column) with a strict >, and with ``with_conf`` a running sum of
    2^((logit − max)·log2 e), rescaled when the max rises; after the last
    tile the quad's four partials combine as its shuffles do, lane t with
    t ^ 1, then with t ^ 2 (``_combine``), and lane 0's is the row's.
    The two consumer warpgroups own different rows, so the order in which
    they fold does not enter. Returns int32 ids and, with ``with_conf``,
    exp(max − logsumexp)."""
    m_rows, v = logits.shape
    n_tiles = -(-v // TILE_N)
    padded = torch.full((m_rows, n_tiles * TILE_N), -torch.inf, dtype=torch.float32)
    padded[:, :v] = logits
    log2e = 1.4426950408889634
    best = dict(m=torch.full((m_rows, 4), -torch.inf), s=torch.zeros((m_rows, 4)),
                idx=torch.full((m_rows, 4), 0x7FFFFFFF, dtype=torch.int64))
    for n in range(n_tiles):
        cols = n * TILE_N + _THREAD_COLS                  # (4, 64), ascending per thread
        tile = padded[:, cols]                            # (M, 4, 64)
        m_old = best["m"]
        for c in range(cols.shape[1]):
            upd = tile[..., c] > best["m"]
            best["m"] = torch.where(upd, tile[..., c], best["m"])
            best["idx"] = torch.where(upd, cols[:, c], best["idx"])
        if with_conf:
            ml = best["m"] * log2e
            s = torch.where(best["m"] > m_old, best["s"] * torch.exp2(m_old * log2e - ml),
                            best["s"])
            for c in range(cols.shape[1]):
                s = s + torch.exp2(tile[..., c] * log2e - ml)
            best["s"] = torch.where(best["m"] == -torch.inf, best["s"], s)
    for o in (1, 2):
        lanes = torch.arange(4) ^ o
        best = _combine(best, {k: t[:, lanes] for k, t in best.items()}, with_conf)
    ids = best["idx"][:, 0].to(torch.int32)
    if not with_conf:
        return ids
    m, s = best["m"][:, 0], best["s"][:, 0]
    return ids, torch.exp(m - (torch.log(s) + m))


def _operands(name: str, h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor):
    """Checks the operands; returns M, V and the entry point's suffix for
    their type ("" for fp32, "_bf16")."""
    m, v = h.shape[0], emb.shape[0]
    bf16 = h.dtype == torch.bfloat16
    dt = torch.bfloat16 if bf16 else torch.float32
    require(name, h, "h", (m, K), dtype=dt)
    require(name, emb, "emb", (v, K), dtype=dt)
    require(name, bias, "bias", (v,))
    if h.data_ptr() % 16 or emb.data_ptr() % 16:
        raise ValueError(f"{name}: h and emb must be 16-byte aligned (16-byte cp.async loads)")
    return m, v, "_bf16" if bf16 else ""


def mlm_argmax_conf(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor):
    """(M, K) × (V, K), both fp32 or both bf16, + (V,) fp32 → (ids (M,) int32,
    conf (M,) fp32)."""
    if runs_plain("mlm_argmax_conf", h, emb, bias):
        return mlm_argmax_ref(h, emb, bias, with_conf=True)
    m, v, suffix = _operands("mlm_argmax_conf", h, emb, bias)
    ids = torch.empty((m,), dtype=torch.int32, device=h.device)
    conf = torch.empty((m,), dtype=torch.float32, device=h.device)
    check("mlm_argmax_conf", kernel(f"mlm_argmax_conf{suffix}_fwd")(
        h.data_ptr(), emb.data_ptr(), bias.data_ptr(), ids.data_ptr(), conf.data_ptr(),
        m, v, stream_of(h)))
    count_launch(mlm_argmax_conf, h.dtype)
    return ids, conf


def mlm_argmax(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor, *,
               with_conf: bool = False):
    """argmax over ``h @ embᵀ + bias``. h: (..., K) and emb: (V, K), both fp32
    or both bf16; bias: (V,) fp32.
    Returns int32 ids shaped like h[..., 0], plus fp32 confidences when
    ``with_conf`` (through ``mlm_argmax_conf``)."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if with_conf:
        ids, conf = mlm_argmax_conf(h2, emb, bias)
        return ids.reshape(lead), conf.reshape(lead)
    if runs_plain("mlm_argmax", h2, emb, bias):
        return mlm_argmax_ref(h2, emb, bias).reshape(lead)
    m, v, suffix = _operands("mlm_argmax", h2, emb, bias)
    ids = torch.empty((m,), dtype=torch.int32, device=h.device)
    check("mlm_argmax", kernel(f"mlm_argmax{suffix}_fwd")(
        h2.data_ptr(), emb.data_ptr(), bias.data_ptr(), ids.data_ptr(), m, v,
        stream_of(h2)))
    count_launch(mlm_argmax, h2.dtype)
    return ids.reshape(lead)


mlm_argmax.launches = collections.Counter()
mlm_argmax_conf.launches = collections.Counter()
