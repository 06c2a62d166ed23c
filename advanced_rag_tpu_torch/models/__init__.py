"""Models of the port: tokenizer, encoders, embedders, reranker."""
