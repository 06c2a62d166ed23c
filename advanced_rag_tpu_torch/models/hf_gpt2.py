"""The HF GPT-2 (and GPT-SW3), GPT-Neo and GPT-J families as one
``nn.Module``, with the numerics of their Flax modules.

Flax's three modules are pre-LN decoder stacks that differ by switches
(``model_type`` in ``HFConfig``), and so does this one:

- GPT-2's projections are ``Conv1D``s: the weight is stored ``[in, out]``
  and multiplies from the right, and Q/K/V come from one ``c_attn``;
  GPT-Neo's and GPT-J's are ``Linear``s, their Q/K/V without biases (and
  GPT-J's output projection too);
- positions: GPT-2's and GPT-Neo's learned ``wpe`` at ``arange(L)`` over
  the padded row (so a left-padded row's tokens sit at shifted positions,
  as in JAX); GPT-J rotates the first ``rotary_dim`` columns of each
  head's q and k (``rotate_every_two``, Flax's sin-then-cos table of numpy
  f32 sines, each repeated twice), in f32, then casts them to the dtype;
- GPT-Neo's layers alternate by ``attention_layers``: a local layer's
  query i sees key j where ``i - window_size < j <= i``
  (``causal ^ tril(causal, -window_size)``), and its attention is
  unscaled: q is multiplied by ``sqrt(head_dim)`` in the dtype, then
  divided by it again, as Flax does;
- GPT-J has one LayerNorm a layer and runs attention and MLP side by side
  on it: ``x + (attn(ln(x)) + mlp(ln(x)))``; GPT-2 and GPT-Neo
  ``x + attn(ln_1(x))``, then ``x + mlp(ln_2(x))``;
- the dtypes Flax leaves: GPT-2's ``wte`` and ``wpe`` take the compute
  dtype; GPT-Neo's ``wte`` / ``wpe`` and GPT-J's ``wte`` have none, so in
  bf16 their sum and the whole residual stream stay f32 until ``ln_f``.

Attention follows Flax's ``dot_product_attention_weights``: q divided by
``sqrt(head_dim)`` rounded to the dtype, the logits in the dtype plus
``finfo(dtype).min`` where the causal mask, the window or the padding
hides a key (never ``-inf``: a bucket's zero rows and a left-padded row's
first queries see no live key, and must stay finite), the softmax cast to
the dtype.  LayerNorm takes ``layer_norm_epsilon`` with f32 statistics.

The projections' weights are held in the compute dtype (Flax casts its
f32 parameters at every call; one cast at load gives the same values and
keeps a 6B GPT-J in bf16 on the card), the LayerNorms and the tables f32.
The parameter names are transformers' ``GPT2Model`` / ``GPTNeoModel`` /
``GPTJModel``'s, so a checkpoint read by ``models/hf_checkpoint.py``
(``transformer.`` prefix removed, old checkpoints' mask buffers and
GPT-2's cross-attention dropped) loads with ``load_state_dict``.  JAX runs
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
from .hf_bert import activation, layer_norm
from .hf_checkpoint import HFConfig


def gptj_sincos(length: int, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows 0..length-1 of Flax GPT-J's ``create_sinusoidal_positions``:
    sin and cos [length, dim // 2] of the f32 angles, each then repeated
    twice along the last axis ([length, dim])."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2) / dim))
    angles = np.einsum("i , j -> i j", np.arange(length), inv_freq).astype("float32")
    return (np.repeat(np.sin(angles), 2, axis=-1).astype(np.float32),
            np.repeat(np.cos(angles), 2, axis=-1).astype(np.float32))


def rotate_every_two(t: torch.Tensor) -> torch.Tensor:
    """``[-t1, t0, -t3, t2, ...]`` along the last axis."""
    return torch.stack((-t[..., 1::2], t[..., 0::2]), dim=-1).flatten(-2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """Flax's ``dot_product_attention_weights`` in ``dtype``, then the
    values: q, k, v [B, L, H, Dh]; bias [B or 1, 1, L, L] in ``dtype``;
    returns [B, L, H * Dh]."""
    bsz, seq, heads, dim = q.shape
    q = q.to(dtype) / torch.tensor(math.sqrt(dim), dtype=dtype)
    logits = torch.matmul(q.transpose(1, 2), k.to(dtype).permute(0, 2, 3, 1)) + bias
    weights = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.matmul(weights, v.to(dtype).transpose(1, 2))          # [B, H, L, Dh]
    return out.transpose(1, 2).reshape(bsz, seq, heads * dim)


def causal_mask_bias(mask: torch.Tensor, window: int, dtype: torch.dtype) -> torch.Tensor:
    """[B, 1, L, L] in ``dtype``: 0 where query i sees key j (j <= i, the key
    not padding, and with a window ``j > i - window``), ``finfo.min``
    elsewhere."""
    pos = torch.arange(mask.shape[1], device=mask.device)
    seen = pos[None, :] <= pos[:, None]
    if window:
        seen &= pos[None, :] > pos[:, None] - window
    seen = seen[None, None] & (mask[:, None, None, :] > 0)
    return torch.zeros(seen.shape, dtype=dtype, device=mask.device).masked_fill_(
        ~seen, torch.finfo(dtype).min)


class Conv1D(nn.Module):
    """GPT-2's projection: ``x @ weight + bias`` with ``weight`` [in, out]."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(d_out, dtype=dtype))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.matmul(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)


class GPT2Attention(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.c_attn = Conv1D(h, 3 * h, dtype)
        self.c_proj = Conv1D(h, h, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                positions=None) -> torch.Tensor:
        bsz, seq, h = x.shape
        q, k, v = (t.view(bsz, seq, self.heads, h // self.heads)
                   for t in self.c_attn(x, dtype).split(h, dim=-1))
        return self.c_proj(attend(q, k, v, bias, dtype), dtype)


class GPTNeoSelfAttention(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(h, h, bias=False, dtype=dtype)
                                                 for _ in range(3))
        self.out_proj = nn.Linear(h, h, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                positions=None) -> torch.Tensor:
        bsz, seq, h = x.shape
        dim = h // self.heads

        def heads(layer: nn.Linear) -> torch.Tensor:
            return dense(x, layer, dtype).view(bsz, seq, self.heads, dim)

        # unscaled: Flax multiplies q by sqrt(head_dim) in the dtype, and
        # dot_product_attention_weights divides it again
        q = heads(self.q_proj) * torch.tensor(math.sqrt(dim), dtype=dtype)
        return dense(attend(q, heads(self.k_proj), heads(self.v_proj), bias, dtype),
                     self.out_proj, dtype)


class GPTNeoAttention(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        self.attention = GPTNeoSelfAttention(config, dtype)

    def forward(self, x, bias, dtype, positions=None):
        return self.attention(x, bias, dtype)


class GPTJAttention(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.rotary_dim = config.rotary_dim
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(h, h, bias=False, dtype=dtype) for _ in range(4))

    def forward(self, x: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                positions=None) -> torch.Tensor:
        bsz, seq, h = x.shape
        dim, rd = h // self.heads, self.rotary_dim
        sin, cos = positions

        def heads(layer: nn.Linear) -> torch.Tensor:
            return dense(x, layer, dtype).view(bsz, seq, self.heads, dim)

        def rotary(t: torch.Tensor) -> torch.Tensor:
            rot = t[..., :rd].float()
            rot = (rot * cos + rotate_every_two(rot) * sin).to(dtype)
            return torch.cat((rot, t[..., rd:]), dim=-1)

        q, k = rotary(heads(self.q_proj)), rotary(heads(self.k_proj))
        return dense(attend(q, k, heads(self.v_proj), bias, dtype), self.out_proj, dtype)


class GPT2MLP(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        h, inner = config.hidden_size, config.intermediate_size
        self.c_fc = Conv1D(h, inner, dtype)
        self.c_proj = Conv1D(inner, h, dtype)
        self.act = activation(config.hidden_act)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x, dtype)), dtype)


class LinearMLP(nn.Module):
    """GPT-Neo's ``c_fc`` / ``c_proj`` or GPT-J's ``fc_in`` / ``fc_out``."""

    def __init__(self, config: HFConfig, names: Tuple[str, str], dtype: torch.dtype):
        super().__init__()
        h, inner = config.hidden_size, config.intermediate_size
        self.names = names
        setattr(self, names[0], nn.Linear(h, inner, dtype=dtype))
        setattr(self, names[1], nn.Linear(inner, h, dtype=dtype))
        self.act = activation(config.hidden_act)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        fc_in, fc_out = (getattr(self, n) for n in self.names)
        return dense(self.act(dense(x, fc_in, dtype)), fc_out, dtype)


_ATTENTION = {"gpt2": GPT2Attention, "gpt-sw3": GPT2Attention,
              "gpt_neo": GPTNeoAttention, "gptj": GPTJAttention}


class GPTBlock(nn.Module):
    def __init__(self, config: HFConfig, dtype: torch.dtype):
        super().__init__()
        family, h, eps = config.model_type, config.hidden_size, config.layer_norm_eps
        self.parallel = family == "gptj"
        self.ln_1 = nn.LayerNorm(h, eps=eps)
        self.attn = _ATTENTION[family](config, dtype)
        if not self.parallel:
            self.ln_2 = nn.LayerNorm(h, eps=eps)
        self.mlp = (GPT2MLP(config, dtype) if family in ("gpt2", "gpt-sw3") else
                    LinearMLP(config, ("c_fc", "c_proj") if family == "gpt_neo"
                              else ("fc_in", "fc_out"), dtype))

    def forward(self, x: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                positions=None) -> torch.Tensor:
        h = layer_norm(x, self.ln_1, dtype)
        if self.parallel:
            return (self.attn(h, bias, dtype, positions) + self.mlp(h, dtype)) + x
        x = self.attn(h, bias, dtype, positions) + x
        return self.mlp(layer_norm(x, self.ln_2, dtype), dtype) + x


class GPTModel(nn.Module):
    """The trunk of GPT-2 / GPT-SW3, GPT-Neo or GPT-J: ``forward(ids,
    mask, type_ids)`` (token types ignored: the families have none)
    returns ``ln_f``'s output [B, L, H] in the compute dtype and None."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        family, h = config.model_type, config.hidden_size
        self.wte = nn.Embedding(config.vocab_size, h)
        if family != "gptj":
            self.wpe = nn.Embedding(config.max_position_embeddings, h)
        self.h = nn.ModuleList(GPTBlock(config, dtype)
                               for _ in range(config.num_hidden_layers))
        self.ln_f = nn.LayerNorm(h, eps=config.layer_norm_eps)
        # GPT-2's Embeds take the dtype; GPT-Neo's and GPT-J's have none
        self.table_dtype = dtype if family in ("gpt2", "gpt-sw3") else torch.float32
        self.windows = [config.window_size if kind == "local" else 0
                        for kind in config.attention_layers] or [0] * len(self.h)
        self._tables: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}

    def rotary_table(self, seq: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """GPT-J's sin, cos [1, L, 1, rotary_dim] f32 on ``device``."""
        key = (seq, str(device))
        if key not in self._tables:
            self._tables[key] = tuple(torch.from_numpy(t)[None, :, None, :].to(device)
                                      for t in gptj_sincos(seq, self.config.rotary_dim))
        return self._tables[key]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        dt, td, seq = self.dtype, self.table_dtype, ids.shape[1]
        x = self.wte.weight[ids].to(td)
        positions = None
        if self.config.model_type == "gptj":
            positions = self.rotary_table(seq, ids.device)
        else:
            x = x + self.wpe.weight[:seq].to(td)[None]
        biases = {w: causal_mask_bias(mask, w, dt) for w in set(self.windows)}
        for block, window in zip(self.h, self.windows):
            x = block(x, biases[window], dt, positions)
        return layer_norm(x, self.ln_f, dt), None


__all__ = ["GPTModel", "attend", "causal_mask_bias", "gptj_sincos", "rotate_every_two"]
