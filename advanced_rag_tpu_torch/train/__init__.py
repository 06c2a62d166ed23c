"""Training of the port's encoders: the port of ``advanced_rag_tpu/train``.

- ``contrastive.py``: the bi-encoder's InfoNCE step (in-batch and mined
  hard negatives) and optax's optimizer chain on ``torch.optim``;
- ``loop.py``: ``train_biencoder`` and the encoder checkpoints;
- ``rerank.py``: the listwise hard-negative reranker (warm start from the
  bi-encoder, residual objective, label smoothing, attention dropout,
  early stopping) and its checkpoints;
- ``distill.py``: label-free distillation of a cross-encoder from the
  bi-encoder.

Every entry point trains on the CUDA card unless given ``device="cpu"``.
The JAX functions return Flax params; the port returns the trained
module's f32 state dict, which ``NeuralEmbedder(state_dict=...)`` and
``CrossEncoderReranker(state_dict=...)`` take.  The steps run over a
(data, model) mesh of ``torch.distributed`` ranks (``build_train_mesh``,
``param_partition_spec``): the batch split over ``data``, the weights and
their optimizer state held as slices over ``model`` between steps and
gathered whole for each step; without a process group the mesh is one
rank.  A checkpoint is a directory with ``config.json`` (the
``EncoderConfig`` fields and the model's own geometry) and ``weights.pt``
(one f32 state dict, read with ``torch.load(..., weights_only=True)``);
no orbax.
"""

from .contrastive import (TrainConfig, build_train_mesh, make_optimizer, make_train_step,
                          param_partition_spec, synthetic_pair_batch)
from .distill import DistillConfig, distill_cross_encoder
from .loop import (TrainLoopConfig, load_biencoder, load_params, save_biencoder,
                   save_params, train_biencoder)
from .rerank import (RerankTrainConfig, filter_false_negatives, load_reranker,
                     save_reranker, token_jaccard, train_reranker,
                     warm_start_cross_encoder)

__all__ = [
    "DistillConfig",
    "RerankTrainConfig",
    "filter_false_negatives",
    "load_reranker",
    "save_reranker",
    "token_jaccard",
    "train_reranker",
    "warm_start_cross_encoder",
    "TrainConfig",
    "TrainLoopConfig",
    "build_train_mesh",
    "param_partition_spec",
    "distill_cross_encoder",
    "load_biencoder",
    "load_params",
    "save_biencoder",
    "make_optimizer",
    "make_train_step",
    "save_params",
    "synthetic_pair_batch",
    "train_biencoder",
]
