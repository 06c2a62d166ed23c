"""The HF RoBERTa encoder, which also serves XLM-RoBERTa, as ``nn.Module``s
with the numerics of Flax RoBERTa.

``FlaxXLMRobertaModel`` is Flax's RoBERTa module under another name, so one
port serves ``model_type`` ``roberta`` and ``xlm-roberta``.  The trunk is
``hf_bert.py``'s; what differs:

- position ids come from the token ids (``create_position_ids_from_input_ids``):
  ``cumsum(ids != pad) * (ids != pad) + pad``, so padding takes position
  ``pad_token_id`` and the first token ``pad_token_id + 1``;
- ``type_vocab_size`` is 1 in the published checkpoints and LayerNorm's eps
  is their config's (1e-5), both read from ``config.json``;
- the classification head is ``dense`` -> ``tanh`` -> ``out_proj`` on token
  0, with no pooler on that path.

The parameter names are transformers' ``RobertaModel`` /
``RobertaForSequenceClassification``'s (``roberta.`` prefix for the
classifier's trunk).  The JAX package runs these through XLA and reaches
no Pallas kernel, so plain torch ops are the port.
"""

from __future__ import annotations

import torch
from torch import nn

from .hf_bert import BertModel, ClassificationHead
from .hf_checkpoint import HFConfig


def position_ids(ids: torch.Tensor, pad: int) -> torch.Tensor:
    """Flax's ``create_position_ids_from_input_ids``."""
    keep = (ids != pad).long()
    return torch.cumsum(keep, dim=1) * keep + pad


class RobertaModel(BertModel):
    """RoBERTa's trunk; ``forward`` as ``BertModel``'s, without a pooler."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__(config, pooler=False, dtype=dtype)

    def embed(self, ids: torch.Tensor, type_ids: torch.Tensor) -> torch.Tensor:
        return self.embeddings(ids, type_ids, self.dtype,
                               positions=position_ids(ids, self.config.pad_token_id))


class RobertaForSequenceClassification(nn.Module):
    """``forward`` returns the logits [B, num_labels] in ``dtype``."""

    def __init__(self, config: HFConfig, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.roberta = RobertaModel(config, dtype=dtype)
        self.classifier = ClassificationHead(config, torch.tanh)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> torch.Tensor:
        hidden, _ = self.roberta(ids, mask, type_ids)
        return self.classifier(hidden, self.roberta.dtype)


__all__ = ["RobertaForSequenceClassification", "RobertaModel", "position_ids"]
