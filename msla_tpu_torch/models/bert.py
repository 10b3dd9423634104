"""Audio-BERT task (port of msla_tpu/models/bert.py).

BERT masked-LM over VQ code ids: the input is padded to whole 512-token
windows, the windows are folded into the batch of one BERT call (all of them
on the card, up to 512 sequences; one per call on the CPU), the argmax of the
tied-decoder logits (``ops.mlm_argmax``, the fused kernel on the card) is
rescaled into the codebook's range, mapped through the frozen codebook, and a
Conv1d(64→4, k4, s2, p1) + Linear(T/8 → T) head gives the 4 stems.

Training (msla_tpu/models/bert.py:161-175, 229-358): the ids are masked with
p = ``mask_prob`` ([MASK] = 103) from the step's generator; BERT, the argmax
and the rescale run under ``torch.no_grad()`` (the argmax passes no gradient,
so BERT receives none, as in the reference and the JAX package), the
codebook gather and the head under grad; the loss is the sum of four L1 stem
losses, and AdamW trains the head alone. BERT's parameters and the codebook
buffer are frozen (``requires_grad=False``, outside the optimizer) and go to
a checkpoint's sidecar (``frozen_param_keys``). BERT runs deterministic, as
in the JAX task's training.

``pretrained_weights`` names the msgpack file ``tools/convert_hf_bert.py``
writes, or an HF ``BertForMaskedLM`` state_dict saved with ``torch.save``;
either loads strictly. A path that does not exist warns and keeps the random
init, as in the JAX task.
"""
from __future__ import annotations

import dataclasses
import logging
import random
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.models.demo import log_audio_demo
from msla_tpu_torch.models.module import TaskModule
from msla_tpu_torch.nn.bert import BertConfig, BertForMaskedLM
from msla_tpu_torch.nn.layers import conv1d, linear
from msla_tpu_torch.ops.conv_adjoints import fp32_convs
from msla_tpu_torch.ops.metrics import l1_loss, mse_loss, si_sdr_mean
from msla_tpu_torch.ops.mlm_argmax import mlm_argmax
from msla_tpu_torch.parallel.mesh import all_max
from msla_tpu_torch.train.checkpoint import ZIP_MAGIC
from msla_tpu_torch.utils import msgpack
from msla_tpu_torch.utils.jax_compat import (adam_state_from_jax,
                                             audio_bert_head_state_dict_from_jax,
                                             audio_bert_state_dict_from_jax,
                                             bert_state_dict_from_jax)

log = logging.getLogger(__name__)

INSTRUMENTS = ("bass", "drums", "guitar", "piano")
MAX_HIDDEN_SIZE = 512  # the BERT window


def mask_tokens(x: torch.Tensor, uniform: torch.Tensor, mask_prob: float,
                mask_token_id: int = 103) -> torch.Tensor:
    """[MASK] where a uniform draw falls below ``mask_prob`` (the JAX task's
    ``jax.random.uniform(rng, x.shape) < mask_prob``)."""
    return torch.where(uniform < mask_prob, mask_token_id, x)


def read_bert_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``BertForMaskedLM`` state_dict from the msgpack params file
    ``tools/convert_hf_bert.py`` writes, or from a ``torch.save``'d HF
    ``BertForMaskedLM`` state_dict, told apart by the first bytes."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == ZIP_MAGIC:
        return torch.load(path, map_location="cpu", weights_only=True)
    if msgpack.is_msgpack_map(head):
        return bert_state_dict_from_jax(msgpack.read(path))
    raise ValueError(f"{path} is neither a msgpack params file nor a torch.save state_dict")


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
    # the argmax detaches BERT, and the codebook is a buffer: neither changes
    frozen_param_keys = ("bert", "codebook")

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
        self.hparams = dict(learning_rate=learning_rate, checkpoint_dir=str(checkpoint_dir),
                            codebook=str(codebook), sample_rate=sample_rate,
                            frame_length=frame_length, num_embedding=num_embedding,
                            mask_prob=mask_prob, compute_dtype=compute_dtype,
                            chunk_fold=chunk_fold)
        self.config = dataclasses.replace(config or BertConfig(), compute_dtype=compute_dtype,
                                          use_flash=use_flash)
        self.mask_prob = float(mask_prob)
        self.chunk_fold = chunk_fold  # None → auto (see _fold_for)

        dev = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        bert = BertForMaskedLM(self.config, device=dev, generator=generator)
        codebook_np = self._load_codebook(codebook, num_embedding)
        output_dim = sample_rate * frame_length
        head = AudioBertHead(codebook_np.shape[1], output_dim // 8, output_dim,
                             generator=generator, device=dev)
        self.net = AudioBertNet(bert, head, torch.from_numpy(codebook_np).to(dev))
        if pretrained_weights:
            self._load_pretrained(Path(pretrained_weights))
        bert.requires_grad_(False)

    def _load_pretrained(self, path: Path) -> None:
        if not path.exists():
            log.warning("pretrained BERT weights %s not found: using random init (run "
                        "tools/convert_hf_bert.py to convert an offline HF checkpoint)", path)
            return
        self.net.bert.load_state_dict(read_bert_weights(path))
        log.info("loaded pretrained BERT weights from %s", path)

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
        fp32, over the whole batch, in the JAX package's operation order. In
        a data-parallel step the largest id is the global batch's, as JAX's
        ``flat.max()`` over the global array is (an all-reduce, MAX)."""
        flat = ids.reshape(-1).to(torch.float32)
        denom = torch.clamp(all_max(flat.max()), min=1.0)
        k = self.net.codebook.shape[0]
        return torch.round(flat / denom * (k - 1)).to(torch.int64)

    def forward(self, indices: torch.Tensor, generator: torch.Generator | None = None,
                train: bool = False) -> torch.Tensor:
        """(B, W) code ids → (B, 4, T) stems. ``train`` with a ``generator``
        masks the ids first; ``train`` runs the head under grad, otherwise
        all runs under ``torch.inference_mode``."""
        if not train:
            with torch.inference_mode():
                return self._stems(indices, None)
        return self._stems(indices, generator)

    def _stems(self, indices: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        b = indices.shape[0]
        x = indices.reshape(b, -1).to(device=self.device, dtype=torch.int64)
        return self.head_stems(self.bert_code_ids(x, generator), b)

    @torch.no_grad()  # the argmax passes no gradient: BERT gets none
    def bert_code_ids(self, x: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, W) token ids → (B·W,) code ids: the mask drawn from ``generator``
        (when given), BERT, the fused argmax and the rescale."""
        if generator is not None:
            uniform = torch.rand(x.shape, generator=generator, device=x.device)
            x = mask_tokens(x, uniform, self.mask_prob, self.config.mask_token_id)
        return self._code_ids(self._chunked_argmax(x, with_conf=False))

    def head_stems(self, code_ids: torch.Tensor, batch: int) -> torch.Tensor:
        """(B·W,) code ids → (B, 4, T): the frozen codebook's rows, then the head."""
        quantized = self.net.codebook.index_select(0, code_ids).reshape(
            batch, -1, self.net.codebook.shape[1])
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

    def state_dict_from_jax(self, params) -> dict[str, torch.Tensor]:
        return audio_bert_state_dict_from_jax(params)

    def optimizer_state_from_jax(self, optimizer, opt_state) -> dict:
        """``optax.multi_transform``'s state: the "train" label's
        ``adamw`` (``ScaleByAdamState`` first in its chain) holds the head's
        moments; the frozen parts' are masked, with no state, as torch's
        AdamW over the head has none for them."""
        adam = opt_state["inner_states"]["train"]["inner_state"]["0"]
        return adam_state_from_jax(optimizer, self.net, adam,
                                   lambda tree: audio_bert_head_state_dict_from_jax(tree["head"]))

    def configure_optimizer(self) -> torch.optim.Optimizer:
        """AdamW on the head alone (optax.adamw under ``multi_transform`` with
        ``set_to_zero`` for BERT and the codebook in the JAX task)."""
        return torch.optim.AdamW(self.net.head.parameters(), lr=self.hparams["learning_rate"],
                                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)

    def loss_fn(self, batch, generator=None):
        indices, instruments = batch
        output = self.forward(indices, generator, train=True)
        loss = torch.zeros((), device=output.device)
        for i in range(4):
            loss = loss + l1_loss(output[:, i, :], instruments[:, i, :])
        return loss, {"train/loss": loss}

    def eval_metrics(self, batch, mode: str) -> dict[str, torch.Tensor]:
        """Validation/test metric catalog (reference: bert.py:107-167)."""
        indices, instruments = batch
        output = self.forward(indices, train=False)
        mixed_output = output.sum(dim=1)
        mixed = instruments.sum(dim=1)
        metrics = {}
        loss = torch.zeros((), device=output.device)
        for i, name in enumerate(INSTRUMENTS):
            pred, target = output[:, i, :], instruments[:, i, :]
            loss = loss + l1_loss(pred, target)
            metrics[f"{mode}/l2_{name}_loss"] = mse_loss(pred, target)
            metrics[f"{mode}/l1_{name}_loss"] = l1_loss(pred, target)
            metrics[f"{mode}/si_sdr_{name}_measure"] = si_sdr_mean(pred, target)
        metrics[f"{mode}/si_sdr_full_audio_measure"] = si_sdr_mean(mixed_output, mixed)
        metrics[f"{mode}/l2_full_audio_loss"] = mse_loss(mixed_output, mixed)
        metrics[f"{mode}/l1_full_audio_loss"] = l1_loss(mixed_output, mixed)
        metrics[f"{mode}/loss"] = loss
        return metrics

    @torch.no_grad()
    def on_validation_batch_end(self, trainer, batch: torch.Tensor, batch_idx: int) -> None:
        """The audio demo of one random row of the first validation batch: the
        datamodule's teacher, then ``forward`` (reference: bert.py:169-232)."""
        if batch_idx != 0 or not trainer.loggers:
            return
        index = random.randint(0, batch.shape[0] - 1)
        datamodule = getattr(trainer, "datamodule", None)
        if datamodule is None or getattr(datamodule, "quantize", None) is None:
            return
        stems = batch[index:index + 1]
        decoded = self.forward(datamodule.on_after_batch_transfer(stems)[0])[0]
        log_audio_demo(trainer, self.hparams["checkpoint_dir"], int(self.hparams["sample_rate"]),
                       stems[0].float().cpu().numpy(), decoded.float().cpu().numpy(), "bert")
