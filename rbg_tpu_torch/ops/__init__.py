"""Tensor ops of the serving path: norms, RoPE, paged and ragged attention."""
