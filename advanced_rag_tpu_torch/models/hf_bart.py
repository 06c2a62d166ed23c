"""The HF encoder-decoder families BART, mBART, Pegasus, Marian, Blenderbot
and BlenderbotSmall as one ``nn.Module``, with the numerics of their Flax
modules.

Flax's six modules are copies of ``FlaxBartModule`` that differ by
switches (``model_type`` in ``HFConfig``), and so does this one:

- positions: BART's and mBART's are learned with an offset of 2 (a table
  of ``max_position_embeddings + 2`` rows), Blenderbot's and
  BlenderbotSmall's learned with none; Marian's and Pegasus's are
  sinusoids computed at build time (``sinusoids``: sin in the first half
  of the width, cos in the second, in float64 then f32), and a saved table
  is not read;
- ``layernorm_embedding`` after the embeddings in BART, mBART and
  BlenderbotSmall (whose decoder normalizes the token embeddings before
  it adds the positions); the token embeddings are multiplied by
  ``sqrt(d_model)`` rounded to their dtype where ``scale_embedding`` is set;
- BART, Marian and BlenderbotSmall are post-LN (``LN(x + f(x))``); mBART,
  Pegasus and Blenderbot pre-LN (``x + f(LN(x))``) with a final
  ``layer_norm`` on each stack;
- the dtypes Flax leaves: the token table is taken in the compute dtype
  except Marian's (f32), the learned positions in the compute dtype for
  BART only (f32 for mBART, Blenderbot and BlenderbotSmall), the
  sinusoids in the token embeddings' dtype; an f32 sum stays f32 until
  the next LayerNorm, so Blenderbot's pre-LN residual stream is f32;
- the decoder's input is ``shift_tokens_right``: the row moved one to the
  right behind ``decoder_start_token_id``, or for mBART behind the row's
  last non-pad token (its language code; found at the count of non-pad
  tokens less one, which wraps to the last column in a row of pad ids).

Attention follows ``FlaxBartAttention``: the query divided by
``sqrt(head_dim)`` rounded to the dtype, the logits in the dtype plus
``finfo(dtype).min`` where a key is hidden, the softmax cast to the dtype.
The encoder's mask hides its padding in the encoder and in the decoder's
cross-attention; the decoder's self-attention is causal only (JAX's
``HFEmbedder`` passes no decoder mask, and Flax fills it with ones).
LayerNorm takes ``eps`` 1e-5 (Flax hard-codes it) with f32 statistics.

The projections' weights are held in the compute dtype (Flax casts its
f32 parameters at every call; one cast at load gives the same values),
the LayerNorms' and the tables f32.  The parameter names are
transformers' ``BartModel`` & co.'s, so a checkpoint read by
``models/hf_checkpoint.py`` (``model.`` prefix removed, the tied
``embed_tokens`` copies and the computed sinusoids dropped) loads with
``load_state_dict``.  ``forward`` returns the decoder's last hidden state,
which JAX's ``HFEmbedder`` mean-pools with the encoder's mask.  JAX runs
these models through XLA and reaches no Pallas kernel, so plain torch ops
are the port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .encoder import dense
from .hf_bert import activation, attention_bias, layer_norm
from .hf_checkpoint import SINUSOIDAL, HFConfig

#: the pre-LN families, with a final layer_norm on each stack
PRE_LN = ("mbart", "pegasus", "blenderbot")
#: the families with layernorm_embedding
EMBEDDING_LN = ("bart", "mbart", "blenderbot-small")
#: the families whose learned positions are offset by 2
OFFSET_2 = ("bart", "mbart")


def sinusoids(n_pos: int, dim: int) -> np.ndarray:
    """Flax's ``create_sinusoidal_positions``: [n_pos, dim] f32 of the
    float64 angles ``pos / 10000^(2 (j // 2) / dim)``, sin of the even
    columns in the first half, cos of the odd ones in the second."""
    j = np.arange(dim)
    angles = np.arange(n_pos)[:, None] / np.power(10000, 2 * (j // 2) / dim)[None, :]
    half = dim // 2 + dim % 2
    out = np.zeros_like(angles)
    out[:, :half] = np.sin(angles[:, 0::2])
    out[:, half:] = np.cos(angles[:, 1::2])
    return out.astype(np.float32)


def shift_tokens_right(ids: torch.Tensor, pad_id: int,
                       start_id: Optional[int]) -> torch.Tensor:
    """The decoder's input: ``ids`` one column to the right behind
    ``start_id``, or, where that is None (mBART), behind each row's token
    at its count of non-pad ids less one (-1 wraps to the last column)."""
    if start_id is None:
        last = (ids != pad_id).sum(-1) - 1
        last = torch.where(last < 0, last + ids.shape[1], last)
        first = ids.gather(1, last[:, None])
    else:
        first = torch.full_like(ids[:, :1], start_id)
    return torch.cat((first, ids[:, :-1]), dim=1)


def causal_bias(seq: int, dtype: torch.dtype, device) -> torch.Tensor:
    """[1, 1, L, L]: 0 where key j <= query i, ``finfo(dtype).min`` after."""
    pos = torch.arange(seq, device=device)
    return torch.zeros((1, 1, seq, seq), dtype=dtype, device=device).masked_fill_(
        pos[None, :] > pos[:, None], torch.finfo(dtype).min)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.head_dim = heads, width // heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(width, width, dtype=dtype) for _ in range(4))

    def forward(self, x: torch.Tensor, kv: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        bsz, seq, width = x.shape

        def heads(t: torch.Tensor, layer: nn.Linear) -> torch.Tensor:   # [B, H, L, Dh]
            return dense(t, layer, dtype).view(
                bsz, t.shape[1], self.heads, self.head_dim).transpose(1, 2)

        q = heads(x, self.q_proj) / torch.tensor(math.sqrt(self.head_dim), dtype=dtype)
        logits = torch.matmul(q, heads(kv, self.k_proj).transpose(-1, -2)) + bias
        weights = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.matmul(weights, heads(kv, self.v_proj))
        return dense(out.transpose(1, 2).reshape(bsz, seq, width), self.out_proj, dtype)


class Layer(nn.Module):
    """An encoder layer, or with ``cross`` a decoder layer."""

    def __init__(self, config: HFConfig, heads: int, ffn: int, cross: bool,
                 dtype: torch.dtype):
        super().__init__()
        d = config.hidden_size
        self.self_attn = Attention(d, heads, dtype)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        if cross:
            self.encoder_attn = Attention(d, heads, dtype)
            self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, ffn, dtype=dtype)
        self.fc2 = nn.Linear(ffn, d, dtype=dtype)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.act = activation(config.hidden_act)
        self.pre_ln = config.model_type in PRE_LN

    def _block(self, x: torch.Tensor, ln: nn.LayerNorm, f, dtype: torch.dtype
               ) -> torch.Tensor:
        if self.pre_ln:
            return x + f(layer_norm(x, ln, dtype))
        return layer_norm(x + f(x), ln, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                memory: Optional[torch.Tensor] = None,
                memory_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._block(x, self.self_attn_layer_norm,
                        lambda h: self.self_attn(h, h, bias, dtype), dtype)
        if memory is not None:
            x = self._block(x, self.encoder_attn_layer_norm,
                            lambda h: self.encoder_attn(h, memory, memory_bias, dtype),
                            dtype)
        return self._block(x, self.final_layer_norm, lambda h: dense(
            self.act(dense(h, self.fc1, dtype)), self.fc2, dtype), dtype)


class Stack(nn.Module):
    """The encoder's or (``cross``) the decoder's embeddings and layers;
    the token table is the model's ``shared`` one, passed to ``forward``."""

    def __init__(self, config: HFConfig, cross: bool, dtype: torch.dtype):
        super().__init__()
        family, d = config.model_type, config.hidden_size
        if family not in SINUSOIDAL:
            rows = config.max_position_embeddings + (2 if family in OFFSET_2 else 0)
            self.embed_positions = nn.Embedding(rows, d)
        n, heads, ffn = ((config.decoder_layers, config.decoder_attention_heads,
                          config.decoder_ffn_dim) if cross else
                         (config.num_hidden_layers, config.num_attention_heads,
                          config.intermediate_size))
        self.layers = nn.ModuleList(Layer(config, heads, ffn, cross, dtype)
                                    for _ in range(n))
        if family in EMBEDDING_LN:
            self.layernorm_embedding = nn.LayerNorm(d, eps=1e-5)
        if family in PRE_LN:
            self.layer_norm = nn.LayerNorm(d, eps=1e-5)


class EncoderDecoderModel(nn.Module):
    """The trunk of one of the six families: ``forward(ids, mask,
    type_ids)`` (token types ignored: the families have none) returns the
    decoder's last hidden state [B, L, d] in the compute dtype and None."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        family = config.model_type
        self.shared = nn.Embedding(config.vocab_size, config.hidden_size)
        self.encoder = Stack(config, cross=False, dtype=dtype)
        self.decoder = Stack(config, cross=True, dtype=dtype)
        self.token_dtype = torch.float32 if family == "marian" else dtype
        # mBART's, Blenderbot's and BlenderbotSmall's position Embed has no
        # dtype; the sinusoids take the token embeddings'
        self.position_dtype = (dtype if family == "bart" else self.token_dtype
                               if family in SINUSOIDAL else torch.float32)
        self.offset = 2 if family in OFFSET_2 else 0
        self._tables: Dict[Tuple[int, str], torch.Tensor] = {}

    def positions(self, stack: Stack, seq: int, device) -> torch.Tensor:
        """[L, d] position embeddings of rows 0..L-1 in their Flax dtype."""
        if self.config.model_type in SINUSOIDAL:
            key = (seq, str(device))
            if key not in self._tables:
                table = sinusoids(self.config.max_position_embeddings,
                                  self.config.hidden_size)[:seq]
                self._tables[key] = torch.from_numpy(table).to(device)
            table = self._tables[key]
        else:
            table = stack.embed_positions.weight[self.offset: self.offset + seq]
        return table.to(self.position_dtype)

    def embed(self, stack: Stack, ids: torch.Tensor) -> torch.Tensor:
        dt, tdt = self.dtype, self.token_dtype
        x = self.shared.weight[ids].to(tdt)
        if self.config.scale_embedding:
            x = x * torch.tensor(math.sqrt(self.config.hidden_size), dtype=tdt)
        pos = self.positions(stack, ids.shape[1], ids.device)[None]
        if self.config.model_type == "blenderbot-small" and stack is self.decoder:
            return layer_norm(x, stack.layernorm_embedding, dt) + pos
        x = x + pos
        if self.config.model_type in EMBEDDING_LN:
            x = layer_norm(x, stack.layernorm_embedding, dt)
        return x

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        dt, pre_ln = self.dtype, self.config.model_type in PRE_LN
        memory_bias = attention_bias(mask, dt)
        x = self.embed(self.encoder, ids)
        for layer in self.encoder.layers:
            x = layer(x, memory_bias, dt)
        memory = layer_norm(x, self.encoder.layer_norm, dt) if pre_ln else x
        dec_ids = shift_tokens_right(ids, self.config.pad_token_id,
                                     self.config.decoder_start_token_id)
        x = self.embed(self.decoder, dec_ids)
        bias = causal_bias(ids.shape[1], dt, ids.device)
        for layer in self.decoder.layers:
            x = layer(x, bias, dt, memory, memory_bias)
        return (layer_norm(x, self.decoder.layer_norm, dt) if pre_ln else x), None


__all__ = ["EncoderDecoderModel", "causal_bias", "shift_tokens_right", "sinusoids"]
