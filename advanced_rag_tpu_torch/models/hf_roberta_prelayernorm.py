"""The HF RoBERTa-PreLayerNorm encoder as ``nn.Module``s, with the numerics
of Flax RoBERTa-PreLayerNorm (``FlaxRobertaPreLayerNormModel``).

The embeddings are RoBERTa's (``hf_bert.BertEmbeddings`` with the position
ids of ``hf_roberta.position_ids``: padding at ``pad_token_id``, the first
token at ``pad_token_id + 1``).  The blocks are pre-LN, unlike BERT's:

- ``x + dense(attention(LayerNorm(x)))``: the attention's own
  ``LayerNorm`` before it, none after the residual;
- ``x + dense(act(dense(LayerNorm(x))))``: the intermediate's
  ``LayerNorm`` before the FFN, none after;
- one final ``LayerNorm`` on the encoder's output (the model's own), which
  is the last hidden state the embedder pools.

The classification head is RoBERTa's (``dense`` -> tanh -> ``out_proj`` on
token 0, no pooler on that path).  The parameter names are transformers'
``RobertaPreLayerNormModel`` / ``RobertaPreLayerNormForSequenceClassification``'s
(``roberta_prelayernorm.`` prefix for the classifier's trunk).  The JAX
package runs this model through XLA and reaches no Pallas kernel, so plain
torch ops are the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .encoder import dense
from .hf_bert import (BertEmbeddings, BertSelfAttention, ClassificationHead, activation,
                      attention_bias, layer_norm)
from .hf_checkpoint import HFConfig
from .hf_roberta import position_ids


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class PreLayerNormAttention(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.self = BertSelfAttention(config)
        self.output = _Dense(config.hidden_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)


class PreLayerNormIntermediate(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)


class PreLayerNormLayer(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.attention = PreLayerNormAttention(config)
        self.intermediate = PreLayerNormIntermediate(config)
        self.output = _Dense(config.intermediate_size, config.hidden_size)
        self.act = activation(config.hidden_act)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        att = self.attention
        a = att.self(layer_norm(x, att.LayerNorm, dtype), bias, dtype)
        x = dense(a, att.output.dense, dtype) + x
        inter = self.intermediate
        h = self.act(dense(layer_norm(x, inter.LayerNorm, dtype), inter.dense, dtype))
        return dense(h, self.output.dense, dtype) + x


class PreLayerNormEncoder(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.layer = nn.ModuleList(PreLayerNormLayer(config)
                                   for _ in range(config.num_hidden_layers))


class RobertaPreLayerNormModel(nn.Module):
    """The trunk: ``forward`` returns the last hidden state [B, L, H] in
    ``dtype`` (after the final LayerNorm) and None (no pooler)."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = BertEmbeddings(config)
        self.encoder = PreLayerNormEncoder(config)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dt = self.dtype
        x = self.embeddings(ids, type_ids, dt,
                            positions=position_ids(ids, self.config.pad_token_id))
        bias = attention_bias(mask, dt)
        for layer in self.encoder.layer:
            x = layer(x, bias, dt)
        return layer_norm(x, self.LayerNorm, dt), None


class RobertaPreLayerNormForSequenceClassification(nn.Module):
    """``forward`` returns the logits [B, num_labels] in ``dtype``."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.roberta_prelayernorm = RobertaPreLayerNormModel(config, dtype=dtype)
        self.classifier = ClassificationHead(config, torch.tanh)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> torch.Tensor:
        hidden, _ = self.roberta_prelayernorm(ids, mask, type_ids)
        return self.classifier(hidden, self.roberta_prelayernorm.dtype)


__all__ = ["RobertaPreLayerNormForSequenceClassification", "RobertaPreLayerNormModel"]
