"""Transformer encoders as ``nn.Module``s: the port of
``advanced_rag_tpu/models/encoder.py``.

The same pre-LN trunk backs the bi-encoder (mean pool -> projection -> L2,
plus the learned lexical bag-of-words channel) and the cross-encoder
([CLS] q [SEP] d [SEP] -> scalar, plus the cross-segment exact-match
channel).  The numerics follow the Flax modules step by step, so that
converted weights (``models/convert.py``) give the same function:

- parameters stay f32; activations run in ``config.dtype`` (bf16 by
  default): every dense layer casts its input and parameters to it;
- LayerNorm runs in f32 with epsilon 1e-6 and Flax's variance,
  ``E[x^2] - E[x]^2``;
- attention is an explicit matmul + softmax (no fused operator), the query
  scaled by ``1/sqrt(head_dim)`` rounded to the activation dtype, masked
  logits set to ``finfo(dtype).min`` so a fully padded row comes out
  uniform instead of NaN;
- GELU is the tanh approximation (``flax.linen.gelu``'s default);
- ``pos_embed[:L]`` is sliced to the sequence length;
- in ``train()`` mode with ``config.dropout > 0`` and a ``torch.Generator``
  passed to the forward, the attention weights take Flax's broadcast
  dropout (``MultiHeadDotProductAttention`` with ``broadcast_dropout=True``):
  one keep mask [1, 1, L, L] per block and forward, shared across batch
  and heads, drawn from that generator.  Without a generator the forward
  is deterministic, as a Flax ``apply`` with ``deterministic=True`` (the
  JAX bi-encoder and distillation steps train so); ``eval()`` always is.

``init_bi_encoder`` / ``init_cross_encoder`` draw fresh weights from
Flax's initializers (the distributions, not the numbers: each framework
has its own generator); ``init_weights`` is the simpler seeded draw the
serving models use when no weights are given.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 128
    num_segments: int = 2
    dropout: float = 0.0            # attention dropout rate in train() mode
    dtype: torch.dtype = torch.bfloat16   # activation dtype (params stay f32)
    # cross-segment exact-match channel (CrossEncoder only)
    lexical_match: bool = False
    num_reserved_ids: int = 8       # ids < this never count as matches
    # learned lexical bag-of-words channel (BiEncoder only)
    lexical_pool: bool = False


#: The repo's shipped bi-encoder (``artifacts/biencoder_ckpt``): 6 x 256,
#: 8 heads of 32, MLP 1024, max_len 256, vocab 32768, lexical_pool.
SHIPPED_BIENCODER = EncoderConfig(
    vocab_size=32768, hidden_dim=256, num_layers=6, num_heads=8,
    mlp_dim=1024, max_len=256, lexical_pool=True)
#: Its projection width (the checkpoint's ``out_dim``).
SHIPPED_BIENCODER_OUT_DIM = 384
#: The repo's shipped cross-encoder (``artifacts/reranker_ckpt``): the same
#: trunk geometry with lexical_match (``pool`` kernel [258, 256]).
SHIPPED_RERANKER = EncoderConfig(
    vocab_size=32768, hidden_dim=256, num_layers=6, num_heads=8,
    mlp_dim=1024, max_len=256, dropout=0.1, lexical_match=True,
    lexical_pool=True)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: f32 statistics, eps 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A Flax ``Dense(dtype=dtype)``: input and parameters cast to dtype."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def dropout_multiplier(seq: int, rate: float, dtype: torch.dtype,
                       generator: torch.Generator) -> torch.Tensor:
    """Flax's broadcast attention dropout: [1, 1, seq, seq] of
    ``keep / (1 - rate)`` in ``dtype`` (the divisor rounded to ``dtype``
    first, as Flax does: 1.109375 in bf16 at rate 0.1), ``keep`` drawn
    with probability ``1 - rate`` from ``generator`` on its device."""
    keep = torch.rand((1, 1, seq, seq), generator=generator,
                      device=generator.device) < 1.0 - rate
    # a host scalar tensor: no copy to the device, and its dtype still rounds
    return keep.to(dtype) / torch.tensor(1.0 - rate, dtype=dtype)


class MultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (self-attention); attention
    dropout at ``dropout`` in train() mode when given a generator."""

    def __init__(self, hidden: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.head_dim = hidden // heads
        self.dropout = dropout
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bsz, seq, hid = x.shape
        shape = (bsz, seq, self.heads, self.head_dim)
        q = dense(x, self.query, dtype).view(shape)
        k = dense(x, self.key, dtype).view(shape)
        v = dense(x, self.value, dtype).view(shape)
        q = q / torch.tensor(math.sqrt(self.head_dim), dtype=dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        keep = (mask > 0)[:, None, None, :]                     # [B, 1, 1, L]
        logits = torch.where(keep, logits,
                             torch.tensor(torch.finfo(dtype).min, dtype=dtype))
        weights = torch.softmax(logits, dim=-1).to(dtype)
        if self.training and self.dropout > 0.0 and generator is not None:
            weights = weights * dropout_multiplier(seq, self.dropout, dtype, generator)
        o = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(bsz, seq, hid)
        return dense(o, self.out, dtype)


class TransformerBlock(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        h = config.hidden_dim
        self.ln_attn = LayerNorm(h)
        self.attn = MultiHeadAttention(h, config.num_heads, config.dropout)
        self.ln_mlp = LayerNorm(h)
        self.mlp_in = nn.Linear(h, config.mlp_dim)
        self.mlp_out = nn.Linear(config.mlp_dim, h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.config.dtype
        h = self.ln_attn(x).to(dt)
        x = x + self.attn(h, mask, dt, generator)
        h = self.ln_mlp(x).to(dt)
        h = F.gelu(dense(h, self.mlp_in, dt), approximate="tanh")
        return x + dense(h, self.mlp_out, dt)


def cross_segment_match(ids: torch.Tensor, mask: torch.Tensor,
                        segments: torch.Tensor,
                        num_reserved: int = 8) -> torch.Tensor:
    """[B, L] i32 indicator: this token id also occurs in the other segment
    of the same sequence (ids < ``num_reserved`` and masked slots never
    match)."""
    valid = (mask > 0) & (ids >= num_reserved)
    eq = ids[:, :, None] == ids[:, None, :]
    opp = segments[:, :, None] != segments[:, None, :]
    hit = torch.any(eq & opp & valid[:, None, :], dim=2)
    return (hit & valid).to(torch.int32)


class TransformerTrunk(nn.Module):
    """Token + position + segment embeddings -> N pre-LN blocks -> LN."""

    def __init__(self, config: EncoderConfig, segments: bool = False):
        super().__init__()
        self.config = config
        h = config.hidden_dim
        self.tok_embed = nn.Embedding(config.vocab_size, h)
        self.pos_embed = nn.Parameter(torch.zeros(config.max_len, h))
        self.seg_embed = (nn.Embedding(config.num_segments, h)
                          if segments else None)
        self.blocks = nn.ModuleList(
            TransformerBlock(config) for _ in range(config.num_layers))
        self.final_ln = LayerNorm(h)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                segments: Optional[torch.Tensor] = None,
                extra: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.config.dtype
        x = self.tok_embed(ids).to(dt)
        x = x + self.pos_embed[: ids.shape[1]].to(dt)[None]
        if segments is not None:
            x = x + self.seg_embed(segments).to(dt)
        if extra is not None:
            x = x + extra.to(dt)
        x = x * mask[:, :, None].to(dt)
        for block in self.blocks:
            x = block(x, mask, generator)
        return self.final_ln(x)                                 # f32 out


class BiEncoder(nn.Module):
    """Sentence embedder: trunk -> masked mean pool -> projection -> L2,
    plus the sqrt-tf hashed bag-of-words channel when ``lexical_pool``."""

    def __init__(self, config: EncoderConfig, out_dim: int = 384):
        super().__init__()
        self.config = config
        self.out_dim = out_dim
        self.trunk = TransformerTrunk(config)
        self.proj = nn.Linear(config.hidden_dim, out_dim)
        if config.lexical_pool:
            self.lex_scale = nn.Parameter(torch.ones(config.vocab_size))
            self.lex_proj = nn.Linear(config.vocab_size, out_dim, bias=False)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ids = ids.long()
        mask = mask.float()
        h = self.trunk(ids, mask, generator=generator)          # [B, L, H] f32
        m = mask[:, :, None]
        pooled = torch.sum(h * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
        out = F.linear(pooled, self.proj.weight, self.proj.bias)
        cfg = self.config
        if cfg.lexical_pool:
            # bag of words: special ids, padding and out-of-vocab ids drop
            valid = (mask > 0) & (ids >= cfg.num_reserved_ids) & (ids < cfg.vocab_size)
            bow = torch.zeros((ids.shape[0], cfg.vocab_size),
                              dtype=torch.float32, device=ids.device)
            bow.scatter_add_(1, torch.clamp(ids, 0, cfg.vocab_size - 1),
                             valid.float())
            bow = torch.sqrt(bow)
            out = out + F.linear(bow * self.lex_scale[None, :],
                                 self.lex_proj.weight)
        norm = torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True))
        return out / torch.clamp(norm, min=1e-12)


class CrossEncoder(nn.Module):
    """Pairwise relevance scorer: trunk([CLS] q [SEP] d [SEP]) -> scalar."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        h = config.hidden_dim
        self.trunk = TransformerTrunk(config, segments=True)
        if config.lexical_match:
            self.match_embed = nn.Embedding(2, h)
        self.pool = nn.Linear(h + 2 if config.lexical_match else h, h)
        self.score = nn.Linear(h, 1)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor, segments: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        ids = ids.long()
        mask = mask.float()
        segments = segments.long()
        extra = match = None
        if cfg.lexical_match:
            match = cross_segment_match(ids, mask, segments, cfg.num_reserved_ids)
            extra = self.match_embed(match.long()).to(cfg.dtype)
        h = self.trunk(ids, mask, segments=segments, extra=extra, generator=generator)
        cls = h[:, 0, :]                                        # [B, H]
        if cfg.lexical_match:
            # matched-token fractions per side go straight to the head
            valid = (mask > 0) & (ids >= cfg.num_reserved_ids)
            m = match.float()
            vq = (valid & (segments == 0)).float()
            vd = (valid & (segments == 1)).float()
            qfrac = torch.sum(m * vq, 1) / torch.clamp(torch.sum(vq, 1), min=1.0)
            dfrac = torch.sum(m * vd, 1) / torch.clamp(torch.sum(vd, 1), min=1.0)
            cls = torch.cat([cls, qfrac[:, None], dfrac[:, None]], dim=-1)
        cls = torch.tanh(F.linear(cls, self.pool.weight, self.pool.bias))
        return F.linear(cls, self.score.weight, self.score.bias)[:, 0]


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for an encoder (CPU generator, then move).

    Linear weights ~ N(0, 1/fan_in), biases 0, embedding tables and the
    position table ~ N(0, 0.02), LayerNorm scale 1 / bias 0, lex_scale 1.
    """
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("lex_scale") or (leaf == "scale" and p.dim() == 1):
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif leaf == "weight" and "embed" not in name:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return module


#: Flax's truncated normal: ``truncated_normal(-2, 2)`` scaled so that the
#: result has unit variance (the std of a unit normal cut at +-2)
TRUNC_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights from the Flax modules' initializers, drawn in
    ``named_parameters`` order from ``generator`` (a CPU generator):

    - Dense kernels (attention q/k/v/out, MLP, ``proj``, ``pool``,
      ``score``, ``lex_proj``): lecun normal, truncated at two standard
      deviations, std 1/sqrt(fan_in) (``nn.initializers.lecun_normal``);
    - ``tok_embed``, ``seg_embed``: normal with std 1/sqrt(H) (``nn.Embed``'s
      default);
    - ``pos_embed``, ``match_embed``: normal(0.02);
    - biases 0, LayerNorm scale 1, ``lex_scale`` 1.
    """
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("lex_scale") or (leaf == "scale" and p.dim() == 1):
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif name.endswith(("tok_embed.weight", "seg_embed.weight")):
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        elif leaf == "weight" and "embed" not in name:
            nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.mul_(1.0 / TRUNC_NORMAL_STD / math.sqrt(p.shape[1]))
        else:                                               # pos_embed, match_embed
            p.normal_(0.0, 0.02, generator=generator)
    return module


def _init(module: nn.Module, seed: int,
          device: DeviceLike) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    model = init_flax(module, torch.Generator().manual_seed(seed))
    model = model.to(resolve_device(device))
    return model, model.state_dict()


def init_bi_encoder(config: EncoderConfig, out_dim: int, seed: int = 0,
                    device: DeviceLike = None) -> Tuple[BiEncoder, Dict[str, torch.Tensor]]:
    """-> (BiEncoder on ``device`` (the card unless ``"cpu"``), its state
    dict), weights from Flax's initializers (``init_flax``)."""
    return _init(BiEncoder(config, out_dim=out_dim), seed, device)


def init_cross_encoder(config: EncoderConfig, seed: int = 0,
                       device: DeviceLike = None) -> Tuple[CrossEncoder, Dict[str, torch.Tensor]]:
    """-> (CrossEncoder on ``device``, its state dict), weights from
    Flax's initializers (``init_flax``)."""
    return _init(CrossEncoder(config), seed, device)


__all__ = [
    "EncoderConfig",
    "SHIPPED_BIENCODER",
    "SHIPPED_BIENCODER_OUT_DIM",
    "SHIPPED_RERANKER",
    "LayerNorm",
    "MultiHeadAttention",
    "TransformerBlock",
    "TransformerTrunk",
    "BiEncoder",
    "CrossEncoder",
    "cross_segment_match",
    "init_weights",
    "init_flax",
    "init_bi_encoder",
    "init_cross_encoder",
    "dropout_multiplier",
]
