"""Host-side utilities copied from the JAX package: constants,
exceptions and the embedding cache."""
