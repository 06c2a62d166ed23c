"""Sharding and collectives on ``torch.distributed``: the port of
``advanced_rag_tpu/parallel``.

The mesh of ranks (``mesh.py``), the collectives over one of its axes
(``comm.py``), the cross-shard top-k merges (``topk.py``), the sharded
search programs (exact, partitioned, fused hybrid, retrieve + rerank,
the pod's hierarchical merge) and the latency projection.  Every rank
runs the same function on its own shard (SPMD with explicit ranks); the
per-shard scoring goes through the same kernel wrappers as the unsharded
path.
"""

from .mesh import (
    build_mesh,
    corpus_sharding,
    pad_to_shards,
    replicated,
    single_device_mesh,
)
from .multihost import (
    build_pod_mesh,
    distributed_init,
    hierarchical_merge_topk,
    pod_dense_topk,
)
from .sharded_e2e import (
    make_sharded_retrieve_rerank,
    sharded_ce_scores,
    sharded_token_gather,
)
from .sharded_hybrid import sharded_hybrid_retrieve
from .sharded_ivf import (
    build_sharded_ivf,
    build_sharded_ivfpq,
    sharded_ivf_topk,
    sharded_ivfpq_topk,
)
from .sharded_search import (
    shard_corpus_arrays,
    sharded_dense_topk,
    sharded_sparse_topk,
)
from .topk import gather_merge_topk, tree_merge_topk

__all__ = [
    "build_mesh",
    "build_pod_mesh",
    "distributed_init",
    "hierarchical_merge_topk",
    "pod_dense_topk",
    "single_device_mesh",
    "corpus_sharding",
    "replicated",
    "pad_to_shards",
    "build_sharded_ivf",
    "build_sharded_ivfpq",
    "sharded_dense_topk",
    "sharded_hybrid_retrieve",
    "make_sharded_retrieve_rerank",
    "sharded_ce_scores",
    "sharded_token_gather",
    "sharded_ivf_topk",
    "sharded_ivfpq_topk",
    "sharded_sparse_topk",
    "shard_corpus_arrays",
    "gather_merge_topk",
    "tree_merge_topk",
]
