"""The HF XGLM family as an ``nn.Module``, with the numerics of Flax's
``FlaxXGLMModule``: a pre-LN BART decoder stack without cross-attention,
built from ``hf_bart.Layer``.

- The token embeddings times ``sqrt(d_model)`` (``scale_embedding``) plus
  fairseq's sinusoids (``xglm_sinusoids``: sin in the first half of the
  width, cos in the second, float64 then f32, row 1 zeroed) at
  ``arange(L) + 2``, whatever the padding (PyTorch's XGLM counts positions
  over the live tokens; JAX's, the reference, does not).  Flax's
  ``embed_tokens`` has no dtype, so in bf16 the sum, and the whole
  residual stream, stay f32 until the final ``layer_norm``;
- each layer ``x + attn(LN(x))``, then ``x + fc2(act(fc1(LN(x))))``, every
  LayerNorm at eps 1e-5 (Flax hard-codes it), the self-attention causal
  and blind to padding (``finfo(dtype).min``), as ``hf_bart.Attention``
  computes it.

The parameter names are transformers' ``XGLMModel``'s (``model.`` prefix
removed; a saved sinusoid table is dropped, Flax computes its own).  JAX
runs this model through XLA and reaches no Pallas kernel, so plain torch
ops are the port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .hf_bart import Layer
from .hf_bert import layer_norm
from .hf_checkpoint import HFConfig
from .hf_gpt2 import causal_mask_bias

#: XGLM's positions start past fairseq's padding index
OFFSET = 2


def xglm_sinusoids(n_pos: int, dim: int, padding_idx: int = 1) -> np.ndarray:
    """Flax XGLM's ``create_sinusoidal_positions``: [n_pos, dim] f32."""
    half = dim // 2
    step = math.log(10000) / (half - 1)
    freq = np.exp(np.arange(half) * -step)
    angles = np.arange(n_pos)[:, None] * freq[None, :]
    out = np.concatenate([np.sin(angles), np.cos(angles)], 1).reshape(n_pos, dim)
    out[padding_idx, :] = 0
    return out.astype(np.float32)


class XGLMModel(nn.Module):
    """The XGLM trunk: ``forward(ids, mask, type_ids)`` (token types
    ignored) returns the final ``layer_norm``'s output [B, L, d] in the
    compute dtype and None."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        d = config.hidden_size
        self.embed_tokens = nn.Embedding(config.vocab_size, d)
        self.layers = nn.ModuleList(
            Layer(config, config.num_attention_heads, config.intermediate_size,
                  cross=False, dtype=dtype, pre_ln=True)
            for _ in range(config.num_hidden_layers))
        self.layer_norm = nn.LayerNorm(d, eps=1e-5)
        self._tables: Dict[Tuple[int, str], torch.Tensor] = {}

    def positions(self, seq: int, device) -> torch.Tensor:
        """[L, d] f32: the sinusoids of positions 2 .. L + 1."""
        key = (seq, str(device))
        if key not in self._tables:
            table = xglm_sinusoids(seq + OFFSET, self.config.hidden_size)[OFFSET:]
            self._tables[key] = torch.from_numpy(table).to(device)
        return self._tables[key]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        dt, cfg = self.dtype, self.config
        x = self.embed_tokens.weight[ids]
        if cfg.scale_embedding:
            x = x * math.sqrt(cfg.hidden_size)
        x = x + self.positions(ids.shape[1], ids.device)[None]
        bias = causal_mask_bias(mask, 0, dt)
        for layer in self.layers:
            x = layer(x, bias, dt)
        return layer_norm(x, self.layer_norm, dt), None


__all__ = ["OFFSET", "XGLMModel", "xglm_sinusoids"]
