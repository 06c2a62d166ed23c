"""Models of the port: tokenizer, encoders, embedders, reranker."""

from .hf_embedder import HFEmbedder

__all__ = ["HFEmbedder"]
