"""The HF ELECTRA encoder as ``nn.Module``s, with the numerics of Flax
ELECTRA.

The encoder is ``hf_bert.py``'s (Flax's ELECTRA layers are copies of
BERT's), with no pooler.  What differs:

- the embeddings are ``embedding_size`` wide and Flax's ``nn.Embed`` there
  has no ``dtype``: the tables are looked up and summed in f32, then the
  LayerNorm returns the compute dtype;
- when ``embedding_size != hidden_size`` (electra-small: 128 -> 256) a
  dense ``embeddings_project`` maps them to the encoder's width;
- the classification head is ``dense`` -> erf GELU (``ACT2FN["gelu"]``,
  hard-coded in Flax whatever ``hidden_act`` says) -> ``out_proj`` on
  token 0;
- ``FlaxElectraModel`` fills absent token types with ones, not zeros: the
  embedder, which passes none (as JAX's ``HFEmbedder`` does), must feed
  ones (``hf_embedder.py``).

The parameter names are transformers' ``ElectraModel`` /
``ElectraForSequenceClassification``'s (``electra.`` prefix for the
classifier's trunk).  The JAX package runs these through XLA and reaches
no Pallas kernel, so plain torch ops are the port.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from .encoder import dense
from .hf_bert import BertEmbeddings, BertModel, ClassificationHead
from .hf_checkpoint import HFConfig


class ElectraModel(BertModel):
    """ELECTRA's trunk; ``forward`` as ``BertModel``'s, without a pooler."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__(config, pooler=False, dtype=dtype)
        width = config.embedding_size or config.hidden_size
        self.embeddings = BertEmbeddings(config, width)
        self.embeddings_project = (nn.Linear(width, config.hidden_size)
                                   if width != config.hidden_size else None)

    def embed(self, ids: torch.Tensor, type_ids: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(ids, type_ids, self.dtype, table_dtype=torch.float32)
        if self.embeddings_project is not None:
            x = dense(x, self.embeddings_project, self.dtype)
        return x


class ElectraForSequenceClassification(nn.Module):
    """``forward`` returns the logits [B, num_labels] in ``dtype``."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.electra = ElectraModel(config, dtype=dtype)
        self.classifier = ClassificationHead(config, partial(F.gelu, approximate="none"))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> torch.Tensor:
        hidden, _ = self.electra(ids, mask, type_ids)
        return self.classifier(hidden, self.electra.dtype)


__all__ = ["ElectraForSequenceClassification", "ElectraModel"]
