"""The HF decoder-only families Llama, Mistral and Gemma as one
``nn.Module``, with the numerics of their Flax modules.

The three differ by switches, not by code (``model_type`` in
``HFConfig``):

- Mistral masks a sliding window: query i sees key j where
  ``i - sliding_window <= j <= i`` (Flax's ``triu(causal, -window)``);
- Gemma's head width is its config's ``head_dim`` (Llama's and Mistral's
  ``hidden_size // num_attention_heads``), its RMSNorm scales by
  ``1 + weight``, its embeddings are multiplied by ``sqrt(hidden_size)``
  rounded to the compute dtype, and its MLP takes ``hidden_activation``
  (tanh GELU where that is None).

The forward follows ``FlaxLlamaModule`` / ``FlaxMistralModule`` /
``FlaxGemmaModule`` (what the JAX package's ``FlaxAutoModel`` runs) step
by step:

- the token embeddings in the compute dtype, then pre-norm blocks:
  ``x + attn(rms(x))``, then ``x + mlp(rms(x))``, and a final RMSNorm;
- RMSNorm: the mean of squares in f32, ``x / sqrt(var + eps)`` (a
  division, not ``rsqrt``) cast to the dtype, times the f32 weight, so in
  bf16 its output is f32 (the next Dense casts it back);
- rotary positions: rotate-half with Flax's sin/cos table (numpy f32 at
  theta 10000) at ``arange(L)`` over the padded row, so a left-padded
  row's tokens sit at shifted positions as in JAX; q and k are cast to
  the dtype after the rotation;
- grouped-query attention: the KV heads repeated to the query heads, the
  logits ``(q / sqrt(head_dim)) . k`` in f32 (Flax promotes q and k to f32
  when the dtype is bf16) plus ``finfo(dtype).min`` where the causal mask,
  the window or the padding mask hides a key, the softmax in f32 and cast
  to the dtype before it weighs the values;
- the gated MLP ``down(act(gate(x)) * up(x))``, no biases.

The batch builds its own [L, L] mask (Flax builds a [max_pos, max_pos]
table per layer).  The projections' weights are kept in the compute dtype:
Flax casts its f32 parameters to the dtype at every call, and one cast at
load gives the same values without 14 GB of f32 copies of a 7B model per
forward; the norms' weights stay f32.  The parameter names are
transformers' ``LlamaModel`` / ``MistralModel`` / ``GemmaModel``'s, so a
checkpoint read by ``models/hf_checkpoint.py`` (``model.`` prefix removed,
``lm_head`` left out) loads with ``load_state_dict``.  JAX runs these
models through XLA and reaches no Pallas kernel, so plain torch ops are
the port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .encoder import dense
from .hf_bert import activation
from .hf_checkpoint import HFConfig


def sincos(length: int, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows 0..length-1 of Flax's ``create_sinusoidal_positions(max_pos,
    dim)``: sin and cos [length, dim] f32 of the float64 angles cast to f32,
    each half repeated."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    freqs = np.einsum("i , j -> i j", np.arange(length), inv_freq).astype("float32")
    emb = np.concatenate((freqs, freqs), axis=-1)
    return np.sin(emb), np.cos(emb)


def rotate_half(t: torch.Tensor) -> torch.Tensor:
    half = t.shape[-1] // 2
    return torch.cat((-t[..., half:], t[..., :half]), dim=-1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype: torch.dtype,
             gemma: bool) -> torch.Tensor:
    """Flax's RMSNorm: f32 statistics, a division by ``sqrt``, the normed
    values cast to ``dtype``, times the f32 weight (``1 + weight`` for
    Gemma); the result is f32."""
    xf = x.float()
    normed = (xf / torch.sqrt((xf * xf).mean(-1, keepdim=True) + eps)).to(dtype)
    return ((1.0 + weight) if gemma else weight) * normed


class RMSNorm(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))


class DecoderAttention(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        self.heads = config.num_attention_heads
        self.kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        bias = config.attention_bias
        h, inner, kv = config.hidden_size, self.heads * self.head_dim, self.kv_heads * self.head_dim
        self.q_proj = nn.Linear(h, inner, bias=bias, dtype=dtype)
        self.k_proj = nn.Linear(h, kv, bias=bias, dtype=dtype)
        self.v_proj = nn.Linear(h, kv, bias=bias, dtype=dtype)
        self.o_proj = nn.Linear(inner, h, bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        bsz, seq, _ = x.shape

        def heads(layer: nn.Linear, n: int) -> torch.Tensor:   # [B, L, n, Dh]
            return dense(x, layer, dtype).view(bsz, seq, n, self.head_dim)

        def rotary(t: torch.Tensor) -> torch.Tensor:
            return (t.float() * cos + rotate_half(t).float() * sin).to(dtype)

        q = rotary(heads(self.q_proj, self.heads))
        k = rotary(heads(self.k_proj, self.kv_heads))
        v = heads(self.v_proj, self.kv_heads)
        groups = self.heads // self.kv_heads
        if groups > 1:
            k = torch.repeat_interleave(k, groups, dim=2)
            v = torch.repeat_interleave(v, groups, dim=2)
        q = q.float() / torch.tensor(math.sqrt(self.head_dim), dtype=torch.float32)
        logits = torch.matmul(q.transpose(1, 2), k.float().permute(0, 2, 3, 1)) + bias
        weights = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.matmul(weights, v.transpose(1, 2))             # [B, H, L, Dh]
        return dense(out.transpose(1, 2).reshape(bsz, seq, self.heads * self.head_dim),
                     self.o_proj, dtype)


class DecoderMLP(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        h, inner = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, inner, bias=False, dtype=dtype)
        self.up_proj = nn.Linear(h, inner, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(inner, h, bias=False, dtype=dtype)
        self.act = activation(config.hidden_act)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        up = dense(x, self.up_proj, dtype)
        return dense(up * self.act(dense(x, self.gate_proj, dtype)), self.down_proj, dtype)


class DecoderLayer(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        self.self_attn = DecoderAttention(config, dtype)
        self.mlp = DecoderMLP(config, dtype)
        self.input_layernorm = RMSNorm(config.hidden_size)
        self.post_attention_layernorm = RMSNorm(config.hidden_size)


def attention_mask_bias(mask: torch.Tensor, window: Optional[int],
                        dtype: torch.dtype) -> torch.Tensor:
    """[B, 1, L, L] f32: 0 where query i sees key j (j <= i, the key not
    padding, and ``j >= i - window`` with a window), ``finfo(dtype).min``
    elsewhere."""
    seq = mask.shape[1]
    pos = torch.arange(seq, device=mask.device)
    seen = pos[None, :] <= pos[:, None]
    if window is not None:
        seen &= pos[None, :] >= pos[:, None] - window
    seen = seen[None, None] & (mask[:, None, None, :] > 0)
    return torch.zeros(seen.shape, dtype=torch.float32, device=mask.device).masked_fill_(
        ~seen, torch.finfo(dtype).min)


class DecoderModel(nn.Module):
    """The trunk of Llama, Mistral or Gemma: ``forward(ids, mask,
    type_ids)`` (token types ignored: the families have none) returns the
    final hidden state [B, L, H] (f32 in bf16, as Flax's last RMSNorm
    returns it) and None."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.gemma = config.model_type == "gemma"
        self.window = config.sliding_window if config.model_type == "mistral" else None
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(config, dtype)
                                    for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size)
        self._tables: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}

    def rotary_table(self, seq: int, device: torch.device):
        """sin, cos [1, L, 1, Dh] f32 on ``device``, made once per length."""
        key = (seq, str(device))
        if key not in self._tables:
            sin, cos = sincos(seq, self.config.head_dim)
            self._tables[key] = tuple(torch.from_numpy(t)[None, :, None, :].to(device)
                                      for t in (sin, cos))
        return self._tables[key]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        dt, eps, gemma = self.dtype, self.config.rms_norm_eps, self.gemma
        x = self.embed_tokens.weight[ids].to(dt)
        if gemma:
            x = x * torch.tensor(self.config.hidden_size ** 0.5, dtype=dt)
        bias = attention_mask_bias(mask, self.window, dt)
        sin, cos = self.rotary_table(ids.shape[1], ids.device)
        for layer in self.layers:
            h = rms_norm(x, layer.input_layernorm.weight, eps, dt, gemma)
            x = x + layer.self_attn(h, bias, sin, cos, dt)
            h = rms_norm(x, layer.post_attention_layernorm.weight, eps, dt, gemma)
            x = x + layer.mlp(h, dt)
        return rms_norm(x, self.norm.weight, eps, dt, gemma), None


__all__ = ["DecoderModel", "attention_mask_bias", "rms_norm", "sincos"]
