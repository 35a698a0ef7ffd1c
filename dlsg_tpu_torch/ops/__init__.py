"""Compute ops: Dense/LayerNorm building blocks, LSTM primitives, exact top-k,
beam search."""
