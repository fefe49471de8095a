"""Hand-written CUDA C++ kernels (``csrc/``) and their ``nvcc`` build."""
