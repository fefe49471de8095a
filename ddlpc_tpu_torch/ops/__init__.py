"""Loss, metrics, the gradient codec and its CUDA kernel wrappers."""
