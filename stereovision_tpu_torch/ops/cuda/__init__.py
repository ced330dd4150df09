"""CUDA kernel wrappers: launch on CUDA tensors, plain PyTorch on CPU ones."""
