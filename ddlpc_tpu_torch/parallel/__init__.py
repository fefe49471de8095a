"""Gradient sync and the train/eval steps."""
