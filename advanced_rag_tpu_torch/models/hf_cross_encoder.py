"""HF-checkpoint cross-encoder reranker: the port of
``advanced_rag_tpu/models/hf_cross_encoder.py``.

A local sequence-classification checkpoint of the BERT, RoBERTa, XLM-R,
ELECTRA, RoBERTa-PreLayerNorm, ALBERT, BigBird or RoFormer family (e.g.
``cross-encoder/ms-marco-MiniLM-L-6-v2``,
``cross-encoder/ms-marco-electra-base``, ``BAAI/bge-reranker-base``)
scores (query, document) pairs on the card with the ``score`` /
``score_pairs`` surface of ``models/cross_encoder.py``, so it drops into
the retriever's rerank stage (``RAG_RERANKER=hf:<path>``).  Pairs are the
family's template (``[CLS] q [SEP] d [SEP]``, ``<s> q </s></s> d </s>``)
truncated ``longest_first`` to ``max_len``; where the tokenizer returns no
token types (RoBERTa's, XLM-R's, BigBird's) zeros are fed, as JAX's class
does; the
score is the first logit in f32 (the relevance convention of one-label
heads).

A DistilBERT checkpoint raises ``ValueError`` here: JAX's class passes
``token_type_ids=`` to ``FlaxDistilBertForSequenceClassification``, which
takes none, so the reference raises ``TypeError`` at its first score, and
the port serves no reranker the reference cannot.  So does a Llama,
Mistral or Gemma one: ``FlaxAutoModelForSequenceClassification`` has no
class for those model types.  None of the encoder-decoders reranks either:
for BART and mBART JAX's class passes ``token_type_ids=`` to
``FlaxBartForSequenceClassification`` / ``FlaxMBartForSequenceClassification``,
which take none (``TypeError`` at the first score), and Pegasus, Marian,
Blenderbot and BlenderbotSmall have no Flax sequence classifier
(``ValueError`` "Unrecognized configuration class" at construction).  Nor
do the GPT families (GPT-2, GPT-SW3, GPT-Neo, GPT-J, BLOOM, XGLM):
``FlaxAutoModelForSequenceClassification`` has no class for any of them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .hf_albert import AlbertForSequenceClassification
from .hf_bert import BertForSequenceClassification
from .hf_big_bird import BigBirdForSequenceClassification
from .hf_checkpoint import DECODERS, ENCDEC, GPT, HFConfig, load_checkpoint, read_config
from .hf_electra import ElectraForSequenceClassification
from .hf_embedder import _bucket, check_max_len
from .hf_roberta import RobertaForSequenceClassification
from .hf_roberta_prelayernorm import RobertaPreLayerNormForSequenceClassification
from .hf_roformer import RoFormerForSequenceClassification
from .hf_tokenizer import load_tokenizer

#: the sequence classifiers by model_type (BERT's for any other encoder)
CLASSIFIERS = {"roberta": RobertaForSequenceClassification,
               "xlm-roberta": RobertaForSequenceClassification,
               "electra": ElectraForSequenceClassification,
               "roberta-prelayernorm": RobertaPreLayerNormForSequenceClassification,
               "albert": AlbertForSequenceClassification,
               "big_bird": BigBirdForSequenceClassification,
               "roformer": RoFormerForSequenceClassification}


def build_classifier(config: HFConfig, dtype: torch.dtype):
    """The family's sequence-classification module."""
    return CLASSIFIERS.get(config.model_type, BertForSequenceClassification)(
        config, dtype=dtype)


class HFCrossEncoder:
    """Pairwise relevance scorer from a local HF checkpoint; ``dtype`` is
    the compute dtype (weights stay f32)."""

    def __init__(self, path, *, max_len: int = 256, max_batch: int = 64,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        self.device = resolve_device(device)
        model_type = read_config(path).model_type
        if model_type == "distilbert":
            raise ValueError(
                f"{path}: a DistilBERT checkpoint does not serve as a "
                "cross-encoder: the JAX reference passes token_type_ids, which "
                "FlaxDistilBertForSequenceClassification does not take")
        if model_type in ("bart", "mbart"):
            raise ValueError(
                f"{path}: model_type {model_type!r} does not serve as a "
                "cross-encoder: the JAX reference passes token_type_ids, which its "
                "Flax sequence classifier does not take (TypeError)")
        if model_type in DECODERS + ENCDEC + GPT:
            raise ValueError(
                f"{path}: model_type {model_type!r} does not serve as a "
                "cross-encoder: the JAX reference's "
                "FlaxAutoModelForSequenceClassification has no class for it")
        self.tokenizer = load_tokenizer(path)
        config, state = load_checkpoint(path, head=True)
        check_max_len(max_len, config, path)
        model = build_classifier(config, dtype)
        model.load_state_dict(state)
        self.model = model.to(self.device).eval()
        self.max_len = max_len
        self.max_batch = max_batch

    def _tokenize(self, queries: Sequence[str], documents: Sequence[str],
                  batch: int):
        enc = self.tokenizer(list(queries), list(documents),
                             max_length=self.max_len)
        types = enc.get("token_type_ids")
        arrays = [enc["input_ids"], enc["attention_mask"],
                  np.zeros_like(enc["input_ids"]) if types is None else types]
        if arrays[0].shape[0] < batch:
            pad = ((0, batch - arrays[0].shape[0]), (0, 0))
            arrays = [np.pad(a, pad) for a in arrays]
        return arrays

    @torch.inference_mode()
    def score_pairs(self, queries: Sequence[str],
                    documents: Sequence[str]) -> np.ndarray:
        if len(queries) != len(documents):
            raise ValueError("queries and documents must align")
        n = len(queries)
        out = np.zeros((n,), np.float32)
        for pos in range(0, n, self.max_batch):
            q_chunk = list(queries[pos: pos + self.max_batch])
            d_chunk = list(documents[pos: pos + self.max_batch])
            b = _bucket(len(q_chunk), self.max_batch)
            logits = self.model(*(torch.from_numpy(a).to(self.device)
                                  for a in self._tokenize(q_chunk, d_chunk, b)))
            out[pos: pos + len(q_chunk)] = \
                logits[: len(q_chunk), 0].float().cpu().numpy()
        return out

    def score(self, query: str, documents: Sequence[str]) -> np.ndarray:
        return self.score_pairs([query] * len(documents), list(documents))


__all__ = ["HFCrossEncoder"]
