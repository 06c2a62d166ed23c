"""The HF BERT encoder as ``nn.Module``s, with the numerics of Flax BERT.

``BertModel`` and ``BertForSequenceClassification`` carry the parameter
names of transformers' PyTorch classes, so a checkpoint read by
``models/hf_checkpoint.py`` loads with ``load_state_dict`` as it is.  The
forward follows ``FlaxBertModel`` (what the JAX package runs) step by step:

- word + token-type + position embeddings, each taken in the compute
  dtype and summed in that order, then LayerNorm;
- post-LN blocks: self-attention, dense, LayerNorm of (out + input);
  intermediate dense and activation, dense, LayerNorm of (out + input);
- attention is an explicit matmul + softmax (no fused operator): the query
  scaled by ``1/sqrt(head_dim)`` rounded to the dtype, the additive bias
  ``finfo(dtype).min`` where the mask is 0, the softmax in the dtype;
- LayerNorm takes f32 statistics with Flax's variance ``E[x^2] - E[x]^2``
  at ``layer_norm_eps`` and returns the dtype;
- ``gelu`` is the erf form (``gelu_new`` / ``gelu_pytorch_tanh`` the tanh
  form), unlike ``models/encoder.py``'s tanh GELU;
- a tanh pooler on [CLS] and, for classification, a linear head.

Parameters stay f32; every dense layer casts its input and parameters to
``dtype`` (f32 or bf16), as a Flax module with ``dtype=`` and f32 params.
The JAX package runs this model through XLA and reaches no Pallas kernel,
so plain torch ops are the port.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .encoder import dense
from .hf_checkpoint import HFConfig


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.LayerNorm(epsilon, dtype)`` with f32 parameters."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return ((x - mean) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias).to(dtype)


def activation(name: str):
    if name == "gelu":
        return partial(F.gelu, approximate="none")
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return partial(F.gelu, approximate="tanh")
    if name == "relu":
        return F.relu
    if name in ("silu", "swish"):
        return F.silu
    raise ValueError(f"hidden_act {name!r} is not supported")


class BertEmbeddings(nn.Module):
    """Word + token-type + position embeddings, then LayerNorm.  The
    tables are taken in ``table_dtype`` (the compute dtype for BERT and
    RoBERTa, whose Flax ``nn.Embed`` has ``dtype=``; f32 for ELECTRA's,
    which has none) and summed in that order; ``positions`` [B, L] replaces
    ``arange(L)`` (RoBERTa's offset ids)."""

    def __init__(self, config: HFConfig, width: Optional[int] = None):
        super().__init__()
        h = width or config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=config.layer_norm_eps)

    def forward(self, ids: torch.Tensor, type_ids: torch.Tensor,
                dtype: torch.dtype, positions: Optional[torch.Tensor] = None,
                table_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        td = dtype if table_dtype is None else table_dtype
        pos = self.position_embeddings.weight.to(td)
        pos = (pos[positions] if positions is not None
               else pos[torch.arange(ids.shape[1], device=ids.device)][None])
        x = (self.word_embeddings.weight.to(td)[ids]
             + self.token_type_embeddings.weight.to(td)[type_ids] + pos)
        return layer_norm(x, self.LayerNorm, dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, config: HFConfig, bias: bool = True):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.head_dim = h // self.heads
        self.query = nn.Linear(h, h, bias=bias)
        self.key = nn.Linear(h, h, bias=bias)
        self.value = nn.Linear(h, h, bias=bias)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        bsz, seq, hid = x.shape

        def heads(layer: nn.Linear) -> torch.Tensor:      # [B, H, L, D]
            return dense(x, layer, dtype).view(
                bsz, seq, self.heads, self.head_dim).transpose(1, 2)

        q = heads(self.query) / torch.tensor(math.sqrt(self.head_dim), dtype=dtype)
        logits = torch.matmul(q, heads(self.key).transpose(-1, -2)) + bias
        weights = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.matmul(weights, heads(self.value))
        return out.transpose(1, 2).reshape(bsz, seq, hid)


class _DenseNorm(nn.Module):
    """``dense`` then LayerNorm of (that + the residual)."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        return layer_norm(dense(x, self.dense, dtype) + residual,
                           self.LayerNorm, dtype)


class BertAttention(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.self = BertSelfAttention(config)
        self.output = _DenseNorm(config.hidden_size, config.hidden_size,
                                 config.layer_norm_eps)


class BertIntermediate(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.attention = BertAttention(config)
        self.intermediate = BertIntermediate(config)
        self.output = _DenseNorm(config.intermediate_size, config.hidden_size,
                                 config.layer_norm_eps)
        self.act = activation(config.hidden_act)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        att = self.attention.output(self.attention.self(x, bias, dtype), x, dtype)
        h = self.act(dense(att, self.intermediate.dense, dtype))
        return self.output(h, att, dtype)


class BertEncoder(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(config)
                                   for _ in range(config.num_hidden_layers))


class BertPooler(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)


def attention_bias(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, 1, 1, L]: 0 where attended, ``finfo.min`` where masked, filled on
    the device (a host scalar tensor copied over would wait for the
    stream)."""
    return torch.zeros((mask.shape[0], 1, 1, mask.shape[1]), dtype=dtype,
                       device=mask.device).masked_fill_(mask[:, None, None, :] <= 0,
                                                        torch.finfo(dtype).min)


class BertModel(nn.Module):
    """The trunk: ``forward`` returns the last hidden state [B, L, H] in
    ``dtype`` and, with the pooler, the pooled [CLS] [B, H] (else None).
    The families that share BERT's encoder override ``embed``."""

    def __init__(self, config: HFConfig, *, pooler: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)
        self.pooler = BertPooler(config) if pooler else None

    def embed(self, ids: torch.Tensor, type_ids: torch.Tensor) -> torch.Tensor:
        return self.embeddings(ids, type_ids, self.dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dt = self.dtype
        x = self.embed(ids, type_ids)
        bias = attention_bias(mask, dt)
        for layer in self.encoder.layer:
            x = layer(x, bias, dt)
        pooled = (torch.tanh(dense(x[:, 0], self.pooler.dense, dt))
                  if self.pooler is not None else None)
        return x, pooled


class BertForSequenceClassification(nn.Module):
    """``forward`` returns the logits [B, num_labels] in ``dtype``."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bert = BertModel(config, pooler=True, dtype=dtype)
        self.classifier = nn.Linear(config.hidden_size, config.num_labels)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> torch.Tensor:
        _, pooled = self.bert(ids, mask, type_ids)
        return dense(pooled, self.classifier, self.bert.dtype)


class ClassificationHead(nn.Module):
    """RoBERTa's and ELECTRA's head on token 0: ``dense``, ``act``,
    ``out_proj`` (no pooler on this path)."""

    def __init__(self, config: HFConfig, act):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)
        self.out_proj = nn.Linear(config.hidden_size, config.num_labels)
        self.act = act

    def forward(self, hidden: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(self.act(dense(hidden[:, 0], self.dense, dtype)),
                     self.out_proj, dtype)


__all__ = ["BertForSequenceClassification", "BertModel", "ClassificationHead",
           "attention_bias"]
