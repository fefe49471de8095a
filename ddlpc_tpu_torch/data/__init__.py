"""Synthetic tile datasets and the single-device batcher."""
