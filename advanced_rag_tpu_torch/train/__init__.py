"""Training of the port's encoders: the port of ``advanced_rag_tpu/train``.

So far only the persistence functions are ported: ``loop.py``'s
``save_params``/``load_params``/``save_biencoder``/``load_biencoder`` and
``rerank.py``'s ``save_reranker``/``load_reranker``.  A checkpoint is a
directory with ``config.json`` (the ``EncoderConfig`` fields and the
model's own geometry) and ``weights.pt`` (one f32 state dict, read with
``torch.load(..., weights_only=True)``); no orbax.  The training loops
themselves come with a later slice of the port (ROADMAP.md, queue A item 8).
"""

from .loop import load_biencoder, load_params, save_biencoder, save_params
from .rerank import load_reranker, save_reranker

__all__ = ["save_params", "load_params", "save_biencoder", "load_biencoder",
           "save_reranker", "load_reranker"]
