"""The plain reference of the benchmark: a frozen copy of the port's plain
PyTorch/NumPy path (stereovision_tpu_torch's ops, hostlib and io modules as
they stood when the benchmark was written), with the host middle in NumPy
and no kernel, batching, graph or pool.  It imports nothing of the port or
of the JAX package; pipeline.Reference runs one frame."""
