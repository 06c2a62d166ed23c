"""HF-checkpoint embedder: the port of
``advanced_rag_tpu/models/hf_embedder.py``.

A local encoder checkpoint (e.g. a MiniLM, all-distilroberta or
msmarco-distilbert sentence-transformer, an XLM-R multilingual-e5) or a
decoder-only one (an e5-mistral-7b-instruct, an LLM2Vec Llama) as a
mean-pooled, L2-normalised embedder on the card, under the ``Embedder``
interface that ``MultiIndexManager`` takes.  Nothing is downloaded, and
nothing of ``transformers`` is needed: ``hf_checkpoint.py`` reads the
directory (``model_type`` bert, roberta, xlm-roberta, electra,
distilbert, roberta-prelayernorm, albert, big_bird, roformer, llama,
mistral, gemma, the encoder-decoders bart, mbart, pegasus, marian,
blenderbot and blenderbot-small, or the GPT families gpt2, gpt-sw3,
gpt_neo, gptj, bloom and xglm), ``hf_tokenizer.load_tokenizer``
tokenizes as the family's tokenizer does and ``hf_bert.py`` /
``hf_roberta.py`` / ``hf_electra.py`` / ``hf_distilbert.py`` /
``hf_roberta_prelayernorm.py`` / ``hf_albert.py`` / ``hf_big_bird.py`` /
``hf_roformer.py`` / ``hf_llama.py`` / ``hf_bart.py`` / ``hf_gpt2.py`` /
``hf_bloom.py`` / ``hf_xglm.py`` run the model (``TRUNKS``).  An
encoder-decoder embeds with its decoder's last state, pooled over the
encoder's mask, as JAX's class does with what ``FlaxAutoModel`` returns.
A BigBird checkpoint's ``max_len`` must be a multiple of its
``block_size``, and in ``block_sparse`` at least four blocks
(``hf_big_bird.check_length``): the port raises at construction, where
JAX's class raises at its first encode.

The token types fed to the trunk are what ``FlaxAutoModel`` fills in when
JAX's class passes none: zeros, except ELECTRA's ones.  A decoder's
tokenizer pads on the side its ``tokenizer_config.json`` names (left by
default, as ``LlamaTokenizerFast`` and ``GemmaTokenizerFast`` do; right
for GPT-2's and XGLM's classes, BLOOM's published config says left), and
the model's positions run over the padded row, as JAX's do (BLOOM's
ALiBi counts the live tokens).  A tokenizer without a pad token (Llama's,
Mistral's and GPT-2's ship none) raises
``ValueError`` here, at construction; JAX's class raises at its first
encode ("Asking to pad but the tokenizer does not have a padding token").
"""

from __future__ import annotations

import uuid
from typing import Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .hf_albert import AlbertModel
from .hf_bert import BertModel
from .hf_bart import EncoderDecoderModel
from .hf_big_bird import BigBirdModel, check_length
from .hf_bloom import BloomModel
from .hf_checkpoint import DECODERS, ENCDEC, GPT, LARGE, HFConfig, load_checkpoint
from .hf_distilbert import DistilBertModel
from .hf_electra import ElectraModel
from .hf_gpt2 import GPTModel
from .hf_llama import DecoderModel
from .hf_roberta import RobertaModel
from .hf_roberta_prelayernorm import RobertaPreLayerNormModel
from .hf_roformer import RoFormerModel
from .hf_tokenizer import load_tokenizer
from .hf_xglm import XGLMModel


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def check_max_len(max_len: int, config: HFConfig, path) -> None:
    # JAX's position gather clamps past the table; the port refuses.
    # RoBERTa's ids run from pad_token_id + 1 to max_len + pad_token_id;
    # an encoder-decoder's table holds max_position_embeddings rows past
    # its offset (Blenderbot-400M's 128, BART's 1024), and so does Flax's
    # causal mask.  BLOOM's ALiBi has no table, and Flax builds its causal
    # mask at the batch's length.
    positions = config.max_position_embeddings
    if config.model_type != "bloom" and max_len + config.position_offset > positions:
        extra = (f" past RoBERTa's offset of {config.position_offset}"
                 if config.position_offset else "")
        raise ValueError(f"max_len {max_len}{extra} exceeds the {positions} "
                         f"positions of {path}")
    if config.model_type == "big_bird":
        check_length(max_len, config, f"{path}: max_len")


#: each family's trunk module (BERT's for any other encoder)
TRUNKS = {**{f: DecoderModel for f in DECODERS},
          **{f: EncoderDecoderModel for f in ENCDEC},
          **{f: GPTModel for f in GPT if f not in ("bloom", "xglm")},
          "bloom": BloomModel, "xglm": XGLMModel,
          "roberta": RobertaModel, "xlm-roberta": RobertaModel, "electra": ElectraModel,
          "distilbert": DistilBertModel, "roberta-prelayernorm": RobertaPreLayerNormModel,
          "big_bird": BigBirdModel, "roformer": RoFormerModel}


def build_trunk(config: HFConfig, dtype: torch.dtype):
    """The family's trunk module, without a pooler."""
    if config.model_type == "albert":
        return AlbertModel(config, pooler=False, dtype=dtype)
    cls = TRUNKS.get(config.model_type)
    return (cls(config, dtype=dtype) if cls is not None
            else BertModel(config, pooler=False, dtype=dtype))


class HFEmbedder:
    """Mean-pooled sentence embedder from a local HF checkpoint; ``dtype``
    is the compute dtype (weights stay f32)."""

    def __init__(self, path, *, max_len: int = 128, max_batch: int = 64,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tokenizer = load_tokenizer(path)
        if self.tokenizer.pad_id is None:
            raise ValueError(f"{path}: the tokenizer has no pad_token, and the "
                             "embedder pads every batch to max_len")
        config, state = load_checkpoint(path, head=False, pooler=False)
        check_max_len(max_len, config, path)
        if config.model_type in LARGE:
            # billions of weights skip their random init: the module is
            # built without storage and filled from the checkpoint on the
            # device (none of these families holds a buffer to initialize)
            with torch.device("meta"):
                model = build_trunk(config, dtype)
            model = model.to_empty(device=self.device)
        else:
            model = build_trunk(config, dtype)
        model.load_state_dict(state)
        # FlaxElectraModel fills absent token types with ones
        self.type_id = 1 if config.model_type == "electra" else 0
        self.model = model.to(self.device).eval()
        self.max_len = max_len
        self.max_batch = max_batch
        self.dim = int(config.hidden_size)
        # per-instance cache identity (JAX's class has none): two
        # checkpoints of one width must never exchange cached embeddings
        self.cache_tag = f"hf{self.dim}-{uuid.uuid4().hex[:12]}"

    def _tokenize(self, texts: Sequence[str], batch: int):
        enc = self.tokenizer(list(texts), max_length=self.max_len)
        ids, mask = enc["input_ids"], enc["attention_mask"]
        if ids.shape[0] < batch:
            pad = ((0, batch - ids.shape[0]), (0, 0))
            ids, mask = np.pad(ids, pad), np.pad(mask, pad)
        return ids, mask

    @torch.inference_mode()
    def encode_device(self, texts: Sequence[str]) -> torch.Tensor:
        """[len(texts), dim] f32 on the device, without a host copy."""
        b = _bucket(max(len(texts), 1), self.max_batch)
        ids, mask = (torch.from_numpy(a).to(self.device)
                     for a in self._tokenize(texts, b))
        hidden, _ = self.model(ids, mask, torch.full_like(ids, self.type_id))
        m = mask[:, :, None].float()
        pooled = torch.sum(hidden.float() * m, dim=1) / torch.clamp(
            torch.sum(m, dim=1), min=1.0)
        norm = torch.sqrt(torch.sum(pooled * pooled, dim=-1, keepdim=True))
        return (pooled / torch.clamp(norm, min=1e-12))[: len(texts)]

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dim), np.float32)
        out = np.zeros((len(texts), self.dim), np.float32)
        for pos in range(0, len(texts), self.max_batch):
            chunk = list(texts[pos: pos + self.max_batch])
            out[pos: pos + len(chunk)] = self.encode_device(chunk).cpu().numpy()
        return out


__all__ = ["HFEmbedder", "TRUNKS", "build_trunk", "check_max_len"]
