"""CPU baselines used ONLY for parity measurements, never for serving.

The reference's ANN quality bar is Milvus HNSW (M=16, efConstruction=200,
ef=64 — reference indexing.py:150-153).  ``HNSWBaseline`` is a clean-room
HNSW in C++, so that "recall@10 vs HNSW at equal memory" (BASELINE.json)
is a measured row rather than a claim; chip_smoke.py measures it beside
the port's tiers on the card.
"""

from .hnsw import HNSWBaseline, available

__all__ = ["HNSWBaseline", "available"]
