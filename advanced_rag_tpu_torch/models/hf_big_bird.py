"""The HF BigBird encoder as ``nn.Module``s, with the numerics of Flax
BigBird (``FlaxBigBirdModel``), in both of its attention types.

The embeddings and blocks are BERT's (post-LN; the tables taken in the
compute dtype), with two switches: ``rescale_embeddings`` multiplies the
word embeddings by ``sqrt(hidden_size)`` rounded to the dtype, and
``use_bias`` puts biases on Q, K and V.  Position ids are ``arange(L)``.
The classification head is ``dense`` -> ``hidden_act`` -> ``out_proj`` on
token 0 (Flax runs the pooler too and never reads it).

``attention_type``:

- ``original_full``: BERT's attention (``finfo.min`` bias, the softmax in
  the dtype).
- ``block_sparse`` (``block_sparse_attention``): Flax's
  ``bigbird_block_sparse_attention`` in its five parts over blocks of
  ``block_size`` tokens: query block 0 and the last one see every key;
  query block 1 sees key blocks 0, 1, 2, the last and the random ones;
  each middle block ``j`` (2 .. n-3) sees blocks 0, ``j-1``, ``j``,
  ``j+1``, the random ones and the last; block n-2 sees 0, n-3, n-2, n-1
  and the random ones.  Logits are ``(q . k) * (1 / sqrt(head_dim))``
  plus ``(1 - mask) * -10000.0`` (not ``finfo.min``), that penalty taken
  in the dtype; the output of a padding query is zeroed.  At inference
  Flax draws no random blocks: its adjacency list is all zeros, so each
  of the ``num_random_blocks`` random blocks is key block 0 again, and
  block 0's keys enter those softmaxes ``1 + num_random_blocks`` times,
  each a separate term.  ``random_blocks`` builds that list and the gather
  follows it.

The length rules: a length that is not a multiple of ``block_size`` raises
``ValueError``, as Flax does; so, in ``block_sparse``, does one of fewer
than four blocks (Flax raises ``ZeroDivisionError`` or ``TypeError``
there, from its random-block plan).  ``check_length`` holds both; the
embedder and cross-encoder call it at construction.

The parameter names are transformers' ``BigBirdModel`` /
``BigBirdForSequenceClassification``'s (``bert.`` prefix for the
classifier's trunk).  The JAX package runs this model through XLA (the
block-sparse attention is gathers and batched matmuls there too) and
reaches no Pallas kernel, so plain torch ops are the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .encoder import dense
from .hf_bert import (BertAttention, BertEmbeddings, BertLayer, BertSelfAttention,
                      ClassificationHead, activation, attention_bias, layer_norm)
from .hf_checkpoint import HFConfig

#: Flax's additive mask penalty in the block-sparse attention
MASK_PENALTY = -10000.0
#: the fewest blocks Flax's block-sparse attention runs on
MIN_BLOCKS = 4


def check_length(seq: int, config: HFConfig, where: str = "BigBird") -> None:
    """Raise ``ValueError`` where Flax cannot run ``seq`` tokens."""
    block = config.block_size
    if seq % block:
        raise ValueError(f"{where}: a length of {seq} tokens is not a multiple of "
                         f"block_size {block}")
    if config.attention_type == "block_sparse" and seq // block < MIN_BLOCKS:
        raise ValueError(f"{where}: block_sparse attention needs at least {MIN_BLOCKS} "
                         f"blocks of block_size {block} ({MIN_BLOCKS * block} tokens); "
                         f"{seq} tokens make {seq // block}")


def random_blocks(heads: int, blocks: int, num_random: int,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Flax's random-block adjacency list at inference: [heads, blocks - 2,
    num_random], all zeros (every random block is block 0)."""
    return torch.zeros((heads, blocks - 2, num_random), dtype=torch.long, device=device)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, block: int, rand_attn: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    """Flax BigBird's block-sparse attention.  ``q``, ``k``, ``v`` [B, H,
    L, Dh] in ``dtype``; ``mask`` [B, L] (1 attended, 0 padding);
    ``rand_attn`` [H, L / block - 2, R] the random key blocks of query
    blocks 1 .. n-2.  Returns [B, L, H * Dh]."""
    bsz, heads, seq, dh = q.shape
    nb, r = seq // block, rand_attn.shape[-1]
    scale = torch.tensor(float(np.float32(1.0) / np.sqrt(np.float32(dh))), dtype=dtype)
    m = mask.to(torch.float32)
    to_mask = m[:, None, None, :]                                   # [B, 1, 1, L]
    blocked = m.view(bsz, nb, block)

    def penalty(keep: torch.Tensor) -> torch.Tensor:
        return ((1.0 - keep) * MASK_PENALTY).to(dtype)

    def split(t: torch.Tensor) -> torch.Tensor:                     # [B, H, n, b, Dh]
        return t.view(bsz, heads, nb, block, dh)

    qb, kb, vb = split(q), split(k), split(v)
    hh = torch.arange(heads, device=q.device)[:, None, None]
    # [B, H, n-2, R * b, Dh]: the random key / value blocks of each query block
    gk = kb[:, hh, rand_attn].reshape(bsz, heads, nb - 2, r * block, dh)
    gv = vb[:, hh, rand_attn].reshape(bsz, heads, nb - 2, r * block, dh)
    # [B, H, n-2, b, R * b]: the query block's mask times the random blocks'
    rand_keys = blocked[:, rand_attn].reshape(bsz, heads, nb - 2, r * block)
    rand_mask = blocked[:, None, 1:-1, :, None] * rand_keys[:, :, :, None, :]

    def attend(query, keys, values, keep):
        logits = torch.matmul(query, keys.transpose(-1, -2)) * scale + penalty(keep)
        return torch.matmul(torch.softmax(logits, dim=-1).to(dtype), values)

    # q[0] and q[-1]: every key
    first = attend(qb[:, :, 0], k, v, to_mask)
    last = attend(qb[:, :, -1], k, v, to_mask)
    ones = torch.ones((bsz, 1, 1, r * block), dtype=torch.float32, device=q.device)
    ones4 = torch.ones((bsz, heads, block, 4 * block), dtype=torch.float32,
                       device=q.device)

    def edge(row: int, cols, seq_keep, rand_row: int):
        keys = torch.cat([kb[:, :, c] for c in cols] + [gk[:, :, rand_row]], dim=2)
        values = torch.cat([vb[:, :, c] for c in cols] + [gv[:, :, rand_row]], dim=2)
        keep = torch.minimum(torch.cat([seq_keep, ones], dim=3),
                             torch.cat([ones4, rand_mask[:, :, rand_row]], dim=3))
        return attend(qb[:, :, row], keys, values, keep)

    # q[1]: blocks 0, 1, 2, the last, the random ones
    second = edge(1, (0, 1, 2, -1), torch.cat(
        [to_mask[..., :3 * block], to_mask[..., -block:]], dim=3), 0)
    # q[-2]: blocks 0, n-3, n-2, n-1, the random ones
    second_last = edge(-2, (0, -3, -2, -1), torch.cat(
        [to_mask[..., :block], to_mask[..., -3 * block:]], dim=3), -1)

    # q[2:-2]: block 0, the sliding window of three, the random ones, the last
    mid_q = qb[:, :, 2:-2]                                          # [B, H, n-4, b, Dh]
    win_k = torch.cat([kb[:, :, 1:-3], kb[:, :, 2:-2], kb[:, :, 3:-1]], dim=3)
    win_v = torch.cat([vb[:, :, 1:-3], vb[:, :, 2:-2], vb[:, :, 3:-1]], dim=3)
    win_keep = torch.cat([blocked[:, 1:-3], blocked[:, 2:-2], blocked[:, 3:-1]], dim=2)
    band_mask = (blocked[:, 2:-2, :, None] * win_keep[:, :, None, :])[:, None]
    k0, kl = kb[:, :, 0][:, :, None], kb[:, :, -1][:, :, None]
    inner = torch.matmul(mid_q, win_k.transpose(-1, -2)) * scale + penalty(band_mask)
    rand = (torch.matmul(mid_q, gk[:, :, 1:-1].transpose(-1, -2)) * scale
            + penalty(rand_mask[:, :, 1:-1]))
    first_band = (torch.matmul(mid_q, k0.transpose(-1, -2)) * scale
                  + penalty(to_mask[..., :block][:, :, :, None]))
    last_band = (torch.matmul(mid_q, kl.transpose(-1, -2)) * scale
                 + penalty(to_mask[..., -block:][:, :, :, None]))
    w = torch.softmax(torch.cat([first_band, inner, rand, last_band], dim=-1),
                      dim=-1).to(dtype)
    middle = torch.matmul(w[..., block:4 * block], win_v)
    middle = middle + torch.matmul(w[..., 4 * block:-block], gv[:, :, 1:-1])
    middle = middle + torch.matmul(w[..., :block], vb[:, :, 0][:, :, None])
    middle = middle + torch.matmul(w[..., -block:], vb[:, :, -1][:, :, None])

    ctx = torch.cat([first[:, :, None], second[:, :, None], middle,
                     second_last[:, :, None], last[:, :, None]], dim=2)
    ctx = ctx.reshape(bsz, heads, seq, dh) * m[:, None, :, None].to(dtype)
    return ctx.transpose(1, 2).reshape(bsz, seq, heads * dh)


class BigBirdBlockSparseAttention(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.head_dim = h // self.heads
        self.block = config.block_size
        self.num_random = config.num_random_blocks
        self.query = nn.Linear(h, h, bias=config.use_bias)
        self.key = nn.Linear(h, h, bias=config.use_bias)
        self.value = nn.Linear(h, h, bias=config.use_bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        bsz, seq, _ = x.shape

        def heads(layer: nn.Linear) -> torch.Tensor:      # [B, H, L, Dh]
            return dense(x, layer, dtype).view(
                bsz, seq, self.heads, self.head_dim).transpose(1, 2)

        rand = random_blocks(self.heads, seq // self.block, self.num_random, x.device)
        return block_sparse_attention(heads(self.query), heads(self.key), heads(self.value),
                                      mask, self.block, rand, dtype)


class BigBirdAttention(BertAttention):
    def __init__(self, config: HFConfig):
        super().__init__(config)
        if config.attention_type == "block_sparse":
            self.self = BigBirdBlockSparseAttention(config)
        elif not config.use_bias:
            self.self = BertSelfAttention(config, bias=False)


class BigBirdLayer(BertLayer):
    def __init__(self, config: HFConfig):
        super().__init__(config)
        self.attention = BigBirdAttention(config)


class BigBirdEncoder(nn.Module):
    def __init__(self, config: HFConfig):
        super().__init__()
        self.layer = nn.ModuleList(BigBirdLayer(config)
                                   for _ in range(config.num_hidden_layers))


class BigBirdModel(nn.Module):
    """The trunk: ``forward`` returns the last hidden state [B, L, H] in
    ``dtype`` and None (the pooler is not run)."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.sparse = config.attention_type == "block_sparse"
        self.embeddings = BertEmbeddings(config)
        self.encoder = BigBirdEncoder(config)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dt, cfg = self.dtype, self.config
        check_length(ids.shape[1], cfg)
        emb = self.embeddings
        word = emb.word_embeddings.weight.to(dt)[ids]
        if cfg.rescale_embeddings:
            word = word * torch.tensor(cfg.hidden_size ** 0.5, dtype=dt)
        pos = emb.position_embeddings.weight.to(dt)[: ids.shape[1]][None]
        x = layer_norm(word + emb.token_type_embeddings.weight.to(dt)[type_ids] + pos,
                       emb.LayerNorm, dt)
        # the block-sparse attention takes the mask, the full one a bias
        side = mask if self.sparse else attention_bias(mask, dt)
        for layer in self.encoder.layer:
            x = layer(x, side, dt)
        return x, None


class BigBirdForSequenceClassification(nn.Module):
    """``forward`` returns the logits [B, num_labels] in ``dtype``."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bert = BigBirdModel(config, dtype=dtype)
        self.classifier = ClassificationHead(config, activation(config.hidden_act))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> torch.Tensor:
        hidden, _ = self.bert(ids, mask, type_ids)
        return self.classifier(hidden, self.bert.dtype)


__all__ = ["BigBirdForSequenceClassification", "BigBirdModel", "MASK_PENALTY",
           "MIN_BLOCKS", "block_sparse_attention", "check_length", "random_blocks"]
