"""The HF ALBERT encoder as ``nn.Module``s, with the numerics of Flax ALBERT
(``FlaxAlbertModel``).

- Factorized embeddings: word + token-type + position tables of width
  ``embedding_size`` (Flax's ``nn.Embed`` there has no ``dtype``: they are
  looked up and summed in f32), a LayerNorm that returns the compute
  dtype, then the dense ``embedding_hidden_mapping_in`` to
  ``hidden_size``.
- Shared layers: ``num_hidden_groups`` groups of ``inner_group_num``
  layers each.  Depth step ``i`` of ``num_hidden_layers`` runs every layer
  of group ``int(i / (num_hidden_layers / num_hidden_groups))``, as Flax
  computes it, so albert-base-v2's one group runs its one set of weights
  12 times.
- Each layer is post-LN as BERT's: ``LayerNorm(dense(attention(x)) + x)``
  in the attention module, then ``full_layer_layer_norm(ffn_output(act(
  ffn(a))) + a)``; the attention is ``hf_bert.BertSelfAttention``'s
  (``finfo.min`` bias, the softmax in the dtype).
- The pooler is a dense + tanh on token 0 and feeds the sequence
  classifier's linear ``classifier``; the embedder pools the last hidden
  state and never runs it.

The parameter names are transformers' ``AlbertModel`` /
``AlbertForSequenceClassification``'s (``albert.`` prefix for the
classifier's trunk).  The JAX package runs this model through XLA and
reaches no Pallas kernel, so plain torch ops are the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .encoder import dense
from .hf_bert import BertEmbeddings, BertSelfAttention, activation, attention_bias, layer_norm
from .hf_checkpoint import HFConfig


class AlbertAttention(BertSelfAttention):
    """Q/K/V (``BertSelfAttention``), then ``dense`` and ``LayerNorm`` of
    (that + the input) in one module, as ALBERT names them."""

    def __init__(self, config: HFConfig):
        super().__init__(config)
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        return layer_norm(dense(super().forward(x, bias, dtype), self.dense, dtype) + x,
                          self.LayerNorm, dtype)


class AlbertLayer(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.full_layer_layer_norm = nn.LayerNorm(config.hidden_size,
                                                  eps=config.layer_norm_eps)
        self.attention = AlbertAttention(config)
        self.ffn = nn.Linear(config.hidden_size, config.intermediate_size)
        self.ffn_output = nn.Linear(config.intermediate_size, config.hidden_size)
        self.act = activation(config.hidden_act)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        a = self.attention(x, bias, dtype)
        h = dense(self.act(dense(a, self.ffn, dtype)), self.ffn_output, dtype)
        return layer_norm(h + a, self.full_layer_layer_norm, dtype)


class AlbertLayerGroup(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.albert_layers = nn.ModuleList(AlbertLayer(config)
                                           for _ in range(config.inner_group_num))


class AlbertTransformer(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.embedding_hidden_mapping_in = nn.Linear(config.embedding_size,
                                                     config.hidden_size)
        self.albert_layer_groups = nn.ModuleList(AlbertLayerGroup(config)
                                                 for _ in range(config.num_hidden_groups))


def group_of(step: int, config: HFConfig) -> int:
    """The group that depth step ``step`` runs (Flax's float division)."""
    return int(step / (config.num_hidden_layers / config.num_hidden_groups))


class AlbertModel(nn.Module):
    """The trunk: ``forward`` returns the last hidden state [B, L, H] in
    ``dtype`` and, with the pooler, the pooled token 0 [B, H] (else
    None)."""

    def __init__(self, config: HFConfig, *, pooler: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = BertEmbeddings(config, config.embedding_size)
        self.encoder = AlbertTransformer(config)
        self.pooler = (nn.Linear(config.hidden_size, config.hidden_size)
                       if pooler else None)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dt, enc = self.dtype, self.encoder
        x = self.embeddings(ids, type_ids, dt, table_dtype=torch.float32)
        x = dense(x, enc.embedding_hidden_mapping_in, dt)
        bias = attention_bias(mask, dt)
        for step in range(self.config.num_hidden_layers):
            for layer in enc.albert_layer_groups[group_of(step, self.config)].albert_layers:
                x = layer(x, bias, dt)
        pooled = (torch.tanh(dense(x[:, 0], self.pooler, dt))
                  if self.pooler is not None else None)
        return x, pooled


class AlbertForSequenceClassification(nn.Module):
    """``forward`` returns the logits [B, num_labels] in ``dtype``: the
    linear ``classifier`` on the pooler's output."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.albert = AlbertModel(config, pooler=True, dtype=dtype)
        self.classifier = nn.Linear(config.hidden_size, config.num_labels)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> torch.Tensor:
        _, pooled = self.albert(ids, mask, type_ids)
        return dense(pooled, self.classifier, self.albert.dtype)


__all__ = ["AlbertForSequenceClassification", "AlbertModel", "group_of"]
