"""Dense tensor operators of the pipeline, in PyTorch."""
