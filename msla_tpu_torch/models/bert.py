"""Audio-BERT task, serving half (port of msla_tpu/models/bert.py).

BERT masked-LM over VQ code ids: the input is padded to whole 512-token
windows, the windows are folded into the batch of one BERT call (all of them
on the card, up to 512 sequences; one per call on the CPU), the argmax of the
tied-decoder logits (``ops.mlm_argmax``, the fused kernel on the card) is
rescaled into the codebook's range, mapped through the frozen codebook, and a
Conv1d(64→4, k4, s2, p1) + Linear(T/8 → T) head gives the 4 stems.

Training (masking, the L1 loss, metrics, AdamW on the head) is ROADMAP.md
queue item 5; loading pretrained BERT weights is queue item 8. Their
keywords raise until then.
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.models.module import TaskModule
from msla_tpu_torch.nn.bert import BertConfig, BertForMaskedLM
from msla_tpu_torch.nn.layers import conv1d, linear
from msla_tpu_torch.ops.conv_adjoints import fp32_convs
from msla_tpu_torch.ops.mlm_argmax import mlm_argmax

log = logging.getLogger(__name__)

MAX_HIDDEN_SIZE = 512  # the BERT window
_TRAINING = "Audio-BERT training is ROADMAP.md queue item 5"


class AudioBertHead(nn.Module):
    """Conv1d(64→4, k4, s2, p1) + Linear(W/2 → T) on (B, 64, W) quantized codes."""

    def __init__(self, embedding_dim: int, width: int, output_dim: int, *,
                 generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv = conv1d(embedding_dim, 4, 4, stride=2, padding=1, **kw)
        self.linear = linear(width, output_dim, **kw)

    def forward(self, quantized_bcw: torch.Tensor) -> torch.Tensor:
        with fp32_convs():
            x = self.conv(quantized_bcw)  # (B, 4, W/2)
        if x.shape[-1] != self.linear.in_features:
            raise ValueError(f"AudioBertHead: {quantized_bcw.shape[-1]} codes give "
                             f"{x.shape[-1]} conv outputs; the head's Linear takes "
                             f"{self.linear.in_features} (sample_rate·frame_length / 8)")
        return self.linear(x)


class AudioBertNet(nn.Module):
    """The task's state: ``bert`` (HF key names under ``bert.``), ``head`` and
    the frozen ``codebook`` buffer."""

    def __init__(self, bert: BertForMaskedLM, head: AudioBertHead, codebook: torch.Tensor):
        super().__init__()
        self.bert = bert
        self.head = head
        self.register_buffer("codebook", codebook)


class AudioBertTask(TaskModule):
    def __init__(self,
                 learning_rate: float,
                 checkpoint_dir: str,
                 codebook: str,
                 sample_rate: int,
                 frame_length: int,
                 num_embedding: int,
                 pretrained_weights: str | None = None,
                 mask_prob: float = 0.15,
                 compute_dtype: str | None = None,
                 use_pallas: bool | None = None,
                 use_flash: bool | None = None,
                 chunk_fold: int | None = None,
                 *, device=None, seed: int = 0,
                 config: BertConfig | None = None):
        """Same arguments as the JAX task, plus ``device`` (None → the card),
        the ``seed`` of the random init and, for small test models, a
        ``config`` in place of bert-base (its ``compute_dtype`` and
        ``use_flash`` are set from the arguments). ``use_pallas`` and
        ``use_flash`` None or True run the kernels on the card; False asks
        for the plain versions there, which the port does not offer."""
        if use_pallas is False:  # use_flash=False: BertForMaskedLM raises alike
            raise NotImplementedError(
                "use_pallas=False asks for the plain argmax on the card, which the port "
                "does not offer (ROADMAP.md §3): pass device='cpu' for the plain version")
        if pretrained_weights and Path(pretrained_weights).exists():
            raise NotImplementedError(
                f"pretrained_weights={pretrained_weights}: loading converted BERT weights "
                "is ROADMAP.md queue item 8")
        if pretrained_weights:
            log.warning("pretrained BERT weights %s not found: using random init",
                        pretrained_weights)
        self.hparams = dict(learning_rate=learning_rate, checkpoint_dir=str(checkpoint_dir),
                            codebook=str(codebook), sample_rate=sample_rate,
                            frame_length=frame_length, num_embedding=num_embedding,
                            mask_prob=mask_prob, compute_dtype=compute_dtype,
                            chunk_fold=chunk_fold)
        self.config = dataclasses.replace(config or BertConfig(), compute_dtype=compute_dtype,
                                          use_flash=use_flash)
        self.chunk_fold = chunk_fold  # None → auto (see _fold_for)

        dev = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        bert = BertForMaskedLM(self.config, device=dev, generator=generator)
        codebook_np = self._load_codebook(codebook, num_embedding)
        output_dim = sample_rate * frame_length
        head = AudioBertHead(codebook_np.shape[1], output_dim // 8, output_dim,
                             generator=generator, device=dev)
        self.net = AudioBertNet(bert, head, torch.from_numpy(codebook_np).to(dev))

    @property
    def bert(self) -> BertForMaskedLM:
        return self.net.bert

    @staticmethod
    def _load_codebook(path: str, num_embedding: int) -> np.ndarray:
        """The frozen codebook from the VQ-VAE task's CSV (one header row)."""
        p = Path(path)
        if p.exists():
            arr = np.genfromtxt(p, delimiter=",", skip_header=1).astype(np.float32)
            return np.atleast_2d(arr)
        log.warning("codebook file %s missing: using zeros (train the VQ-VAE first)", path)
        return np.zeros((num_embedding, 64), dtype=np.float32)

    def _fold_for(self, batch: int, n_chunks: int) -> int:
        """Chunks per BERT call: on the card all of them, capped at 512 folded
        sequences (the fused argmax leaves no logits to bound); on the CPU one,
        since the plain argmax holds (fold·B·512, vocab) logits."""
        if self.chunk_fold is not None:
            return max(1, int(self.chunk_fold))
        if self.device.type == "cpu":
            return 1
        return max(1, min(n_chunks, 512 // max(batch, 1)))

    def _decoder_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The tied decoder's operands: the word embeddings, cast to the compute
        dtype when one is set, and the fp32 vocab bias."""
        pred = self.bert.cls.predictions
        emb = pred.decoder.weight
        return (emb if self.bert.dtype is None else emb.to(self.bert.dtype)), pred.bias

    def _fold(self, x: torch.Tensor):
        """(B, W) token ids → tokens and masks (n_groups, fold·B, 512), and the
        map back from such a stack to (B, W).

        Pads W with [PAD] to whole 512-token windows (mask 0 there) and folds
        ``_fold_for`` windows into the batch of each BERT call: within a
        group, row f·B + i is window f of sequence i."""
        b, w = x.shape
        s = MAX_HIDDEN_SIZE
        n_chunks = -(-w // s)
        fold = self._fold_for(b, n_chunks)
        n_groups = -(-n_chunks // fold)
        padded = n_groups * fold * s
        tokens = F.pad(x, (0, padded - w), value=self.config.pad_token_id)
        attn = F.pad(torch.ones((b, w), device=x.device), (0, padded - w))

        def fold_rows(t):
            return t.reshape(b, n_groups, fold, s).permute(1, 2, 0, 3).reshape(
                n_groups, fold * b, s)

        def unfold(o):
            o = o.reshape(n_groups, fold, b, s).permute(2, 0, 1, 3)
            return o.reshape(b, padded)[:, :w]

        return fold_rows(tokens), fold_rows(attn), unfold

    def _chunked_argmax(self, x: torch.Tensor, *, with_conf: bool):
        """(B, W) token ids → (B, W) argmax vocab ids [+ (B, W) confidences],
        one BERT call per group of ``_fold``."""
        tokens, attn, unfold = self._fold(x)
        emb, bias = self._decoder_weights()
        outs = [mlm_argmax(self.bert(tok, am, return_mlm_hidden=True).to(emb.dtype), emb,
                           bias, with_conf=with_conf)
                for tok, am in zip(tokens, attn)]
        if with_conf:
            return tuple(unfold(torch.stack(o)) for o in zip(*outs))
        return unfold(torch.stack(outs))

    def _code_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Vocab ids → code ids: round(ids / max(max(ids), 1) · (K − 1)) in
        fp32, over the whole batch, in the JAX package's operation order."""
        flat = ids.reshape(-1).to(torch.float32)
        denom = torch.clamp(flat.max(), min=1.0)
        k = self.net.codebook.shape[0]
        return torch.round(flat / denom * (k - 1)).to(torch.int64)

    @torch.inference_mode()
    def forward(self, indices: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, W) code ids → (B, 4, T) stems."""
        if train:
            raise NotImplementedError(f"train=True: {_TRAINING}")
        b = indices.shape[0]
        x = indices.reshape(b, -1).to(device=self.device, dtype=torch.int64)
        w = x.shape[1]
        code_ids = self._code_ids(self._chunked_argmax(x, with_conf=False))
        quantized = self.net.codebook.index_select(0, code_ids).reshape(b, w, -1)
        return self.net.head(quantized.transpose(1, 2).contiguous())

    @torch.inference_mode()
    def code_proposals(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, W) token ids → (B, W, 2) [code id, confidence] per position:
        ``forward``'s mapping plus the softmax confidence of each pick (the
        MaskGIT sampler of ``inference.AudioGenerator.sample_codes``)."""
        b, w = tokens.shape
        x = tokens.to(device=self.device, dtype=torch.int64)
        ids, conf = self._chunked_argmax(x, with_conf=True)
        code_ids = self._code_ids(ids).reshape(b, w).to(torch.float32)
        return torch.stack([code_ids, conf], dim=-1)

    def predict_step(self, batch) -> torch.Tensor:
        """Generation path: (indices, stems) → (B, 4, T)."""
        indices, _ = batch
        return self.forward(indices, train=False)

    def configure_optimizer(self):
        raise NotImplementedError(f"configure_optimizer: {_TRAINING}")

    def loss_fn(self, batch, generator=None):
        raise NotImplementedError(f"loss_fn: {_TRAINING}")

    def eval_metrics(self, batch, mode: str):
        raise NotImplementedError(f"eval_metrics: {_TRAINING}")
