"""The HF BLOOM family as an ``nn.Module``, with the numerics of Flax's
``FlaxBloomModule``.

The forward, step by step:

- ``word_embeddings`` taken in the compute dtype, then
  ``word_embeddings_layernorm``; no position table;
- ALiBi built from the mask (``alibi``): each head's slope times the
  key's position counted over the live tokens (``cumsum(mask) - 1``, 0 on
  padding), so a left-padded row's first live token sits at 0; cast to
  the dtype and added to the ``finfo(dtype).min`` mask bias in the dtype;
- each layer ``ln = input_layernorm(x)``, the attention's output plus the
  residual (``ln`` where ``apply_residual_connection_post_layernorm``,
  else ``x``), then ``post_attention_layernorm`` and the MLP plus the
  residual taken the same way; a final ``ln_f``;
- the fused ``query_key_value`` split per head as ``[heads, 3,
  head_dim]``: each head's q, k and v lie side by side;
- the logits and softmax in f32 when the dtype is not f32 (Flax sets
  ``attention_softmax_in_fp32`` so): q and k cast to f32, q divided by
  ``sqrt(head_dim)``, the bias promoted, the weights cast back to the
  dtype before they weigh the values;
- ``BloomGELU``: ``x * 0.5 * (1 + tanh(0.79788456 * x * (1 + 0.044715 *
  x * x)))`` in the dtype, in that order.

Flax's slopes for a head count that is not a power of two call
``jnp.cat`` (which does not exist), so ``hf_checkpoint.read_config``
refuses such a config.  The projections' weights are held in the compute
dtype, the LayerNorms and the table f32; the parameter names are
transformers' ``BloomModel``'s (``transformer.`` prefix removed).  JAX
runs this model through XLA and reaches no Pallas kernel, so plain torch
ops are the port.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .encoder import dense
from .hf_bert import layer_norm
from .hf_checkpoint import HFConfig


def alibi_slopes(heads: int, device=None) -> torch.Tensor:
    """Each head's ALiBi slope, f32 [heads]: ``base ** (1..heads)`` with
    ``base = 2 ** -(8 / heads)`` (``heads`` a power of two)."""
    base = torch.tensor(2 ** (-(2 ** -(math.log2(heads) - 3))), dtype=torch.float32,
                        device=device)
    return torch.pow(base, torch.arange(1, 1 + heads, dtype=torch.float32, device=device))


def alibi(mask: torch.Tensor, heads: int, dtype: torch.dtype) -> torch.Tensor:
    """[B, heads, 1, L] in ``dtype``: the slope times each key's position
    among the row's live tokens (0 on padding)."""
    m = (mask > 0).to(torch.int64)
    positions = ((m.cumsum(-1) - 1) * m)[:, None, :]
    return (alibi_slopes(heads, mask.device)[:, None] * positions)[:, :, None, :].to(dtype)


def bloom_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * x * (1 + 0.044715 * x * x)))


class BloomAttention(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.query_key_value = nn.Linear(h, 3 * h, dtype=dtype)
        self.dense = nn.Linear(h, h, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
        bsz, seq, h = x.shape
        dim = h // self.heads
        fused = dense(x, self.query_key_value, dtype).view(bsz, seq, self.heads, 3 * dim)
        q, k, v = (t.transpose(1, 2) for t in fused.split(dim, dim=-1))   # [B, H, L, Dh]
        soft = torch.float32 if dtype != torch.float32 else dtype
        q = q.to(soft) / torch.tensor(math.sqrt(dim), dtype=soft)
        logits = torch.matmul(q, k.to(soft).transpose(-1, -2)) + bias
        weights = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(bsz, seq, h)
        return dense(out, self.dense, dtype)


class BloomMLP(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        h = config.hidden_size
        self.dense_h_to_4h = nn.Linear(h, 4 * h, dtype=dtype)
        self.dense_4h_to_h = nn.Linear(4 * h, h, dtype=dtype)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(bloom_gelu(dense(x, self.dense_h_to_4h, dtype)), self.dense_4h_to_h,
                     dtype)


class BloomBlock(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.input_layernorm = nn.LayerNorm(h, eps=eps)
        self.self_attention = BloomAttention(config, dtype)
        self.post_attention_layernorm = nn.LayerNorm(h, eps=eps)
        self.mlp = BloomMLP(config, dtype)
        self.post_ln = config.residual_post_ln

    def forward(self, x: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
        ln = layer_norm(x, self.input_layernorm, dtype)
        x = self.self_attention(ln, bias, dtype) + (ln if self.post_ln else x)
        ln = layer_norm(x, self.post_attention_layernorm, dtype)
        return self.mlp(ln, dtype) + (ln if self.post_ln else x)


class BloomModel(nn.Module):
    """The BLOOM trunk: ``forward(ids, mask, type_ids)`` (token types
    ignored) returns ``ln_f``'s output [B, L, H] in the compute dtype and
    None."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.word_embeddings_layernorm = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.h = nn.ModuleList(BloomBlock(config, dtype)
                               for _ in range(config.num_hidden_layers))
        self.ln_f = nn.LayerNorm(h, eps=config.layer_norm_eps)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        dt, seq = self.dtype, ids.shape[1]
        x = layer_norm(self.word_embeddings.weight[ids].to(dt),
                       self.word_embeddings_layernorm, dt)
        pos = torch.arange(seq, device=ids.device)
        seen = (pos[None, :] <= pos[:, None])[None, None] & (mask[:, None, None, :] > 0)
        bias = torch.zeros(seen.shape, dtype=dt, device=ids.device).masked_fill_(
            ~seen, torch.finfo(dt).min) + alibi(mask, self.config.num_attention_heads, dt)
        for block in self.h:
            x = block(x, bias, dt)
        return layer_norm(x, self.ln_f, dt), None


__all__ = ["BloomModel", "alibi", "alibi_slopes", "bloom_gelu"]
