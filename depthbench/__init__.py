"""The benchmark of the PyTorch/CUDA port (stereovision_tpu_torch): see
run.py and BENCHMARK.json at the repository's root."""
