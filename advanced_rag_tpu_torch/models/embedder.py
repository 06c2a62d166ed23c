"""Embedding generators on the device: the port of
``advanced_rag_tpu/models/embedder.py``.

Two implementations behind one interface (``encode(texts) -> [B, D]``):

- ``NeuralEmbedder``: the bi-encoder of ``models/encoder.py``, batched;
- ``HashingEmbedder``: deterministic and training-free, hashed term counts
  through a fixed signed random projection kept on the device.

Both produce L2-normalized f32 vectors, so cosine == inner product and the
dense index can store bf16 and search with metric='ip'.
"""

from __future__ import annotations

import uuid
from typing import Any, Mapping, Optional, Protocol, Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .encoder import BiEncoder, EncoderConfig, init_weights
from .tokenizer import HashingTokenizer, TokenizerConfig


class Embedder(Protocol):
    """Interface the index layer consumes."""

    dim: int

    def encode(self, texts: Sequence[str]) -> np.ndarray: ...


class NeuralEmbedder:
    """The bi-encoder on one device, in batches of ``max_batch`` texts.

    ``state_dict`` holds converted weights (``models/convert.py``); without
    it the weights are random, drawn from a ``torch.Generator`` seeded with
    ``seed`` (on the CPU, so the draw is the same on every machine).
    """

    def __init__(
        self,
        dim: int = 384,
        config: Optional[EncoderConfig] = None,
        state_dict: Optional[Mapping[str, Any]] = None,
        tokenizer: Optional[HashingTokenizer] = None,
        seed: int = 0,
        max_batch: int = 128,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.config = config or EncoderConfig()
        self.dim = dim
        self.tokenizer = tokenizer or HashingTokenizer(
            TokenizerConfig(vocab_size=self.config.vocab_size,
                            max_len=self.config.max_len))
        model = BiEncoder(self.config, out_dim=dim)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(dict(state_dict))
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        # per-instance cache identity: two different models of the same
        # width must never exchange cached embeddings
        self.cache_tag = f"neural{dim}-{uuid.uuid4().hex[:12]}"

    @torch.inference_mode()
    def encode_device(self, texts: Sequence[str]) -> torch.Tensor:
        """[len(texts), dim] f32 on the device, without a host copy."""
        ids, mask = self.tokenizer.encode_batch(list(texts))
        return self.model(torch.from_numpy(ids).to(self.device),
                          torch.from_numpy(mask).to(self.device))

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dim), np.float32)
        out = np.zeros((len(texts), self.dim), np.float32)
        for pos in range(0, len(texts), self.max_batch):
            chunk = texts[pos: pos + self.max_batch]
            out[pos: pos + len(chunk)] = self.encode_device(chunk).cpu().numpy()
        return out


class HashingEmbedder:
    """Deterministic signed-random-projection embedder (device gather).

    Without ``proj`` the projection is drawn from a seeded
    ``torch.Generator``; it is not the JAX package's projection (the two
    frameworks draw different numbers from one seed), only the same
    construction.  ``proj`` ([vocab_size, dim] f32) gives the projection
    itself, for example the JAX embedder's, carried over by
    ``models/convert.py:hashing_from_numpy``.
    """

    def __init__(
        self,
        dim: int = 384,
        vocab_size: int = 16384,
        doc_nnz: int = 128,
        seed: int = 0,
        proj: Optional[Any] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.vocab_size = vocab_size
        self.doc_nnz = doc_nnz
        if proj is None:
            self.cache_tag = f"hash{dim}v{vocab_size}s{seed}"
            gen = torch.Generator().manual_seed(seed)
            signs = torch.randint(0, 2, (vocab_size, dim), generator=gen)
            proj = (signs.float() * 2.0 - 1.0) / np.sqrt(dim)
        else:
            proj = torch.from_numpy(np.array(proj, np.float32, copy=True))
            if tuple(proj.shape) != (vocab_size, dim):
                raise ValueError(f"proj is {tuple(proj.shape)}, expected "
                                 f"({vocab_size}, {dim})")
            # a given projection is not the seeded draw: its own cache
            # identity, so the two never exchange cached embeddings
            self.cache_tag = f"hash{dim}v{vocab_size}p{uuid.uuid4().hex[:12]}"
        self._proj = proj.to(self.device)

    @torch.inference_mode()
    def encode_device(self, texts: Sequence[str]) -> torch.Tensor:
        from ..index.text import encode_documents

        idx, tf, _, _ = encode_documents(list(texts), self.vocab_size, self.doc_nnz)
        idx_t = torch.from_numpy(idx).to(self.device).long()
        tf_t = torch.from_numpy(tf).to(self.device)
        ok = (idx_t >= 0).float()
        rows = self._proj[torch.clamp(idx_t, min=0)]                 # [B, P, D]
        emb = torch.sum(rows * (tf_t * ok)[:, :, None], dim=1)
        norm = torch.sqrt(torch.sum(emb * emb, dim=-1, keepdim=True))
        return emb / torch.clamp(norm, min=1e-12)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dim), np.float32)
        return self.encode_device(texts).cpu().numpy()


__all__ = ["Embedder", "NeuralEmbedder", "HashingEmbedder"]
