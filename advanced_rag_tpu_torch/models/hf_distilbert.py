"""The HF DistilBERT encoder as an ``nn.Module``, with the numerics of Flax
DistilBERT (``FlaxDistilBertModel``).

- Embeddings: word + position, then LayerNorm; no token types.  Flax's
  tables have no ``dtype``, so they are looked up and summed in f32; with
  ``sinusoidal_pos_embds`` the position table is the fixed one Flax builds
  (``sinusoidal_table``) and the checkpoint's is not read.
- Attention: ``q / sqrt(head_dim)`` (the divisor rounded to the dtype), and
  the mask applied as ``scores - 1e30 * (1 - mask)``, not BERT's
  ``finfo.min`` bias.  In bf16 ``1e30`` rounds to 1.0e30 (bf16 reaches
  3.4e38), so a masked score is about -1e30 and takes no weight; a row
  with every key masked (a batch's padding rows) gets uniform weights, as
  in Flax, and no NaN.
- Blocks are post-LN: ``sa_layer_norm(attention + x)``, then
  ``output_layer_norm(ffn + that)``, every LayerNorm at eps 1e-12
  (hard-coded in Flax).

The parameter names are transformers' ``DistilBertModel``'s.  DistilBERT
serves as an embedder only (``hf_cross_encoder.py`` says why).  The JAX
package runs this through XLA and reaches no Pallas kernel, so plain torch
ops are the port.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .encoder import dense
from .hf_bert import activation, layer_norm
from .hf_checkpoint import HFConfig


def sinusoidal_table(positions: int, dim: int) -> torch.Tensor:
    """Flax DistilBERT's ``positional_encoding`` [positions, dim], f32."""
    i = np.arange(dim)[None, :]
    angles = np.arange(positions)[:, None] * (
        1 / np.power(10000, (2 * (i // 2)) / np.float32(dim)))
    angles[:, 0::2] = np.sin(angles[:, 0::2])
    angles[:, 1::2] = np.cos(angles[:, 1::2])
    return torch.from_numpy(angles.astype(np.float32))


class Embeddings(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        if config.sinusoidal_pos_embds:
            self.register_buffer("sinusoidal", sinusoidal_table(
                config.max_position_embeddings, h), persistent=False)
            self.position_embeddings = None
        else:
            self.position_embeddings = nn.Embedding(config.max_position_embeddings, h)
        self.LayerNorm = nn.LayerNorm(h, eps=1e-12)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        table = (self.sinusoidal if self.position_embeddings is None
                 else self.position_embeddings.weight)
        x = self.word_embeddings.weight[ids] + table[: ids.shape[1]][None]
        return layer_norm(x, self.LayerNorm, dtype)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.head_dim = h // self.heads
        self.q_lin, self.k_lin = nn.Linear(h, h), nn.Linear(h, h)
        self.v_lin, self.out_lin = nn.Linear(h, h), nn.Linear(h, h)

    def forward(self, x: torch.Tensor, keep: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """``keep`` [B, 1, 1, L]: the mask in ``dtype``."""
        bsz, seq, hid = x.shape

        def heads(layer: nn.Linear) -> torch.Tensor:      # [B, H, L, D]
            return dense(x, layer, dtype).view(
                bsz, seq, self.heads, self.head_dim).transpose(1, 2)

        q = heads(self.q_lin) / torch.tensor(math.sqrt(self.head_dim), dtype=dtype)
        scores = torch.matmul(q, heads(self.k_lin).transpose(-1, -2))
        scores = scores - torch.tensor(1e30, dtype=dtype) * (1.0 - keep)
        weights = torch.softmax(scores, dim=-1).to(dtype)
        out = torch.matmul(weights, heads(self.v_lin))
        return dense(out.transpose(1, 2).reshape(bsz, seq, hid), self.out_lin, dtype)


class FFN(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.lin1 = nn.Linear(config.hidden_size, config.intermediate_size)
        self.lin2 = nn.Linear(config.intermediate_size, config.hidden_size)


class TransformerBlock(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        h = config.hidden_size
        self.attention = MultiHeadSelfAttention(config)
        self.sa_layer_norm = nn.LayerNorm(h, eps=1e-12)
        self.ffn = FFN(config)
        self.output_layer_norm = nn.LayerNorm(h, eps=1e-12)
        self.act = activation(config.hidden_act)

    def forward(self, x: torch.Tensor, keep: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        sa = layer_norm(self.attention(x, keep, dtype) + x, self.sa_layer_norm, dtype)
        h = dense(self.act(dense(sa, self.ffn.lin1, dtype)), self.ffn.lin2, dtype)
        return layer_norm(h + sa, self.output_layer_norm, dtype)


class Transformer(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.layer = nn.ModuleList(TransformerBlock(config)
                                   for _ in range(config.num_hidden_layers))


class DistilBertModel(nn.Module):
    """``forward`` returns the last hidden state [B, L, H] in ``dtype`` (and
    None: there is no pooler); ``type_ids`` are ignored."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = Embeddings(config)
        self.transformer = Transformer(config)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        dt = self.dtype
        x = self.embeddings(ids, dt)
        keep = mask[:, None, None, :].to(dt)
        for layer in self.transformer.layer:
            x = layer(x, keep, dt)
        return x, None


__all__ = ["DistilBertModel", "sinusoidal_table"]
