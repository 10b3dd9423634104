"""BERT encoder and masked-LM head (port of msla_tpu/nn/bert.py).

bert-base-uncased's architecture: post-norm layers, erf-GELU, LayerNorm eps
1e-12, a decoder tied to the word embeddings. The modules keep HF
``BertForMaskedLM``'s state_dict key names (``bert.embeddings.*``,
``bert.encoder.layer.{i}.*``, ``cls.predictions.*``, the tied
``cls.predictions.decoder.*`` included), so a converted or HF checkpoint loads
strictly. Attention runs through ``nn.attention.attend`` and so through the
flash-attention kernel on the card.

``compute_dtype="bfloat16"`` follows the JAX package's bf16 BERT: the
embeddings, projections, FFN, GELU, LayerNorm outputs and the residual stream
in bf16 (LayerNorm statistics in fp32), attention on bf16 q, k, v with an fp32
output, and the MLM transform in fp32 on the bf16 stream (it has no dtype in
the JAX package) before a bf16 ``mlm_norm``. Parameters stay fp32.

``forward(deterministic=False, generator=g)`` runs the JAX module's dropout
(msla_tpu/nn/bert.py:66, 76, 84): ``hidden_dropout_prob`` on the embeddings'
output and on the attention and FFN branches before their residual adds,
each keep mask drawn from ``g``. The JAX BERT's attention has no dropout
of its own, so attention stays on the flash kernel. Audio-BERT runs BERT
with ``deterministic=True`` in training too (the argmax stops every
gradient into BERT), as the JAX task does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from msla_tpu_torch.device import resolve_device
from msla_tpu_torch.nn.attention import attend
from msla_tpu_torch.nn.layers import compute, dense, dropout, embedding, layer_norm, linear


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    #: None or "float32", or "bfloat16"
    compute_dtype: str | None = None
    #: None or True: the flash-attention kernel on the card
    use_flash: bool | None = None
    pad_token_id: int = 0
    mask_token_id: int = 103


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, *, generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.word_embeddings = embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = embedding(c.max_position_embeddings, c.hidden_size, **kw)
        self.token_type_embeddings = embedding(c.type_vocab_size, c.hidden_size, **kw)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, device=device)
        self.dtype = compute(c.compute_dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        parts = (self.word_embeddings(input_ids), self.position_embeddings.weight[:s][None],
                 self.token_type_embeddings.weight[0])  # token type 0 everywhere
        if self.dtype is not None:  # each embedding cast, then summed in bf16
            parts = [p.to(self.dtype) for p in parts]
        return layer_norm(self.LayerNorm, parts[0] + parts[1] + parts[2], self.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig, *, generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.query = linear(c.hidden_size, c.hidden_size, **kw)
        self.key = linear(c.hidden_size, c.hidden_size, **kw)
        self.value = linear(c.hidden_size, c.hidden_size, **kw)


class BertDense(nn.Module):
    """One ``dense`` Linear and, given an ``eps``, a ``LayerNorm``: HF's
    ``attention.output``, ``intermediate``, ``output`` and
    ``predictions.transform`` blocks."""

    def __init__(self, cin: int, cout: int, eps: float | None, *,
                 generator: torch.Generator, device):
        super().__init__()
        self.dense = linear(cin, cout, generator=generator, device=device)
        if eps is not None:
            self.LayerNorm = nn.LayerNorm(cout, eps=eps, device=device)


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig, *, generator: torch.Generator, device):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.dtype = compute(c.compute_dtype)
        self.self = BertSelfAttention(c, generator=generator, device=device)
        self.output = BertDense(c.hidden_size, c.hidden_size, c.layer_norm_eps,
                                generator=generator, device=device)

    def forward(self, x: torch.Tensor, kv_mask: torch.Tensor, drop=lambda a: a) -> torch.Tensor:
        sa = self.self
        a = attend(sa.query, sa.key, sa.value, self.output.dense, self.num_heads,
                   x, x, x, kv_mask, self.dtype)
        return layer_norm(self.output.LayerNorm, x + drop(a), self.dtype)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, *, generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.dtype = compute(c.compute_dtype)
        self.attention = BertAttention(c, **kw)
        self.intermediate = BertDense(c.hidden_size, c.intermediate_size, None, **kw)
        self.output = BertDense(c.intermediate_size, c.hidden_size, c.layer_norm_eps, **kw)

    def forward(self, x: torch.Tensor, kv_mask: torch.Tensor, drop=lambda a: a) -> torch.Tensor:
        """``drop``: the hidden dropout of the attention and FFN branches."""
        x = self.attention(x, kv_mask, drop)
        h = F.gelu(dense(self.intermediate.dense, x, self.dtype))  # erf-GELU, as HF BERT
        h = dense(self.output.dense, h, self.dtype)
        return layer_norm(self.output.LayerNorm, x + drop(h), self.dtype)


class BertEncoder(nn.Module):
    def __init__(self, c: BertConfig, *, generator: torch.Generator, device):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c, generator=generator, device=device)
                                   for _ in range(c.num_hidden_layers))


class BertModel(nn.Module):
    def __init__(self, c: BertConfig, *, generator: torch.Generator, device):
        super().__init__()
        self.embeddings = BertEmbeddings(c, generator=generator, device=device)
        self.encoder = BertEncoder(c, generator=generator, device=device)


class BertPredictionHead(nn.Module):
    """``cls.predictions``: transform (dense, GELU, LayerNorm), the vocab bias
    and the decoder, whose weight is the word-embedding matrix and whose bias
    is ``bias`` (both shared, as HF ties them)."""

    def __init__(self, c: BertConfig, word_embeddings: nn.Embedding, *,
                 generator: torch.Generator, device):
        super().__init__()
        self.transform = BertDense(c.hidden_size, c.hidden_size, c.layer_norm_eps,
                                   generator=generator, device=device)
        self.bias = nn.Parameter(torch.zeros(c.vocab_size, device=device))
        self.decoder = nn.Linear(c.hidden_size, c.vocab_size, bias=False, device="meta")
        self.decoder.weight = word_embeddings.weight
        self.decoder.bias = self.bias


class BertCLS(nn.Module):
    def __init__(self, c: BertConfig, word_embeddings: nn.Embedding, *,
                 generator: torch.Generator, device):
        super().__init__()
        self.predictions = BertPredictionHead(c, word_embeddings, generator=generator,
                                              device=device)


class BertForMaskedLM(nn.Module):
    def __init__(self, config: BertConfig = BertConfig(), *, device=None, seed: int = 0,
                 generator: torch.Generator | None = None):
        """Weights from a torch.Generator seeded with ``seed`` (or the
        ``generator`` given), with the JAX package's init families; ``device``
        None means the card."""
        super().__init__()
        self.dtype = compute(config.compute_dtype)
        if config.use_flash is False:
            raise NotImplementedError(
                "use_flash=False asks for the plain attention on the card, which the port "
                "does not offer (ROADMAP.md §3): pass device='cpu' for the plain version")
        self.config = config
        dev = resolve_device(device)
        kw = dict(generator=generator or torch.Generator().manual_seed(seed), device=dev)
        self.bert = BertModel(config, **kw)
        self.cls = BertCLS(config, self.bert.embeddings.word_embeddings, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                deterministic: bool = True, return_mlm_hidden: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, S) int ids → (B, S, vocab) MLM logits; with
        ``return_mlm_hidden`` the (B, S, hidden) states after the MLM
        transform and norm (bf16 in bf16 mode), for callers that fuse the
        decoder with an argmax (``ops.mlm_argmax``). With ``deterministic``
        False the hidden dropout draws from ``generator``."""
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, device=input_ids.device)
        attention_mask = attention_mask.to(torch.float32).contiguous()

        def drop(a):
            return dropout(a, self.config.hidden_dropout_prob, generator, deterministic)

        x = drop(self.bert.embeddings(input_ids))
        for layer in self.bert.encoder.layer:
            x = layer(x, attention_mask, drop)
        t = self.cls.predictions.transform
        h = layer_norm(t.LayerNorm, F.gelu(t.dense(x.float())), self.dtype)
        if return_mlm_hidden:
            return h
        pred = self.cls.predictions
        return h.float() @ pred.decoder.weight.T + pred.bias
