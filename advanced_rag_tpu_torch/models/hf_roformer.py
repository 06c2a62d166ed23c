"""The HF RoFormer encoder as ``nn.Module``s, with the numerics of Flax
RoFormer (``FlaxRoFormerModel``).

- Embeddings: word + token-type only (no position table), looked up and
  summed in f32 (Flax's ``nn.Embed`` there has no ``dtype``), then a
  LayerNorm that returns the compute dtype.  Flax has no
  ``embeddings_project``: ``hf_checkpoint.read_config`` refuses an
  ``embedding_size`` other than ``hidden_size``.
- Positions are rotary: Flax's ``create_sinusoidal_positions(
  max_position_embeddings, head_dim)`` (float64 angles
  ``p / 10000^(2 (j // 2) / dim)``; the first half of a row the sines of
  the even columns, the second half the cosines of the odd ones, cast to
  f32), rows ``0..L-1``.  Each half is repeated pairwise
  (``stack([sin, sin], -1)``: s0 s0 s1 s1 ...) and applied to interleaved
  pairs, ``x * cos + [-x1, x0, -x3, x2, ...] * sin``; this is not the
  half-split rotary of ``hf_llama.py``.  The product with the f32 table
  promotes the rotated Q and K to f32 in bf16; Flax's attention casts them
  back to the dtype.  With ``rotary_value`` V is rotated too, and then
  stays f32 in bf16 through its product with the weights.
- The blocks, the attention bias (``finfo.min``) and the softmax are
  BERT's (post-LN).
- The classification head is ``dense`` -> ``hidden_act`` -> ``out_proj``
  on token 0 (no pooler).

The parameter names are transformers' ``RoFormerModel`` /
``RoFormerForSequenceClassification``'s (``roformer.`` prefix for the
classifier's trunk; the checkpoint's ``encoder.embed_positions.weight`` is
not read: Flax computes the table).  The JAX package runs this model
through XLA and reaches no Pallas kernel, so plain torch ops are the port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .encoder import dense
from .hf_bert import (BertAttention, BertIntermediate, BertLayer, ClassificationHead,
                      _DenseNorm, activation, attention_bias, layer_norm)
from .hf_checkpoint import HFConfig


def sinusoidal_positions(positions: int, dim: int) -> np.ndarray:
    """Flax's ``create_sinusoidal_positions(positions, dim)`` [positions,
    dim] f32."""
    j = np.arange(dim)
    enc = np.arange(positions)[:, None] / np.power(10000, 2 * (j // 2) / dim)[None, :]
    half = dim // 2 + dim % 2
    out = np.zeros_like(enc)
    out[:, :half] = np.sin(enc[:, 0::2])
    out[:, half:] = np.cos(enc[:, 1::2])
    return out.astype(np.float32)


def rotate_pairs(t: torch.Tensor) -> torch.Tensor:
    """[-x1, x0, -x3, x2, ...] along the last axis."""
    return torch.stack((-t[..., 1::2], t[..., 0::2]), dim=-1).reshape(t.shape)


class RoFormerEmbeddings(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=config.layer_norm_eps)

    def forward(self, ids: torch.Tensor, type_ids: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        x = self.word_embeddings.weight[ids] + self.token_type_embeddings.weight[type_ids]
        return layer_norm(x, self.LayerNorm, dtype)


class RoFormerSelfAttention(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.head_dim = h // self.heads
        self.rotary_value = config.rotary_value
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``sin``, ``cos`` [1, L, 1, Dh] f32, each pair's value twice."""
        bsz, seq, hid = x.shape

        def heads(layer: nn.Linear) -> torch.Tensor:      # [B, L, H, Dh]
            return dense(x, layer, dtype).view(bsz, seq, self.heads, self.head_dim)

        def rotary(t: torch.Tensor) -> torch.Tensor:
            return t.float() * cos + rotate_pairs(t).float() * sin

        q = rotary(heads(self.query)).to(dtype).transpose(1, 2)
        k = rotary(heads(self.key)).to(dtype).transpose(1, 2)
        v = heads(self.value)
        v = (rotary(v) if self.rotary_value else v).transpose(1, 2)
        q = q / torch.tensor(math.sqrt(self.head_dim), dtype=dtype)
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + bias, dim=-1).to(dtype)
        # with a rotated V the product is f32, as Flax's einsum promotes it
        out = torch.matmul(weights.to(v.dtype), v)
        return out.transpose(1, 2).reshape(bsz, seq, hid)


class RoFormerAttention(BertAttention):
    def __init__(self, config: HFConfig):
        super().__init__(config)
        self.self = RoFormerSelfAttention(config)


class RoFormerLayer(BertLayer):
    def __init__(self, config: HFConfig):
        super().__init__(config)
        self.attention = RoFormerAttention(config)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        att = self.attention.output(self.attention.self(x, bias, sin, cos, dtype), x, dtype)
        h = self.act(dense(att, self.intermediate.dense, dtype))
        return self.output(h, att, dtype)


class RoFormerEncoder(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.layer = nn.ModuleList(RoFormerLayer(config)
                                   for _ in range(config.num_hidden_layers))


class RoFormerModel(nn.Module):
    """The trunk: ``forward`` returns the last hidden state [B, L, H] in
    ``dtype`` and None (no pooler)."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = RoFormerEmbeddings(config)
        self.encoder = RoFormerEncoder(config)
        self._tables: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}

    def rotary_table(self, seq: int, device: torch.device):
        """sin, cos [1, L, 1, Dh] f32 on ``device``, each value repeated
        pairwise; made once per length."""
        key = (seq, str(device))
        if key not in self._tables:
            dim = self.config.hidden_size // self.config.num_attention_heads
            table = sinusoidal_positions(self.config.max_position_embeddings, dim)[:seq]
            sin, cos = np.split(table, 2, axis=-1)
            self._tables[key] = tuple(
                torch.from_numpy(np.repeat(t, 2, axis=-1))[None, :, None, :].to(device)
                for t in (sin, cos))
        return self._tables[key]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dt = self.dtype
        x = self.embeddings(ids, type_ids, dt)
        bias = attention_bias(mask, dt)
        sin, cos = self.rotary_table(ids.shape[1], ids.device)
        for layer in self.encoder.layer:
            x = layer(x, bias, sin, cos, dt)
        return x, None


class RoFormerForSequenceClassification(nn.Module):
    """``forward`` returns the logits [B, num_labels] in ``dtype``."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.roformer = RoFormerModel(config, dtype=dtype)
        self.classifier = ClassificationHead(config, activation(config.hidden_act))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> torch.Tensor:
        hidden, _ = self.roformer(ids, mask, type_ids)
        return self.classifier(hidden, self.roformer.dtype)


__all__ = ["RoFormerForSequenceClassification", "RoFormerModel", "rotate_pairs",
           "sinusoidal_positions"]
