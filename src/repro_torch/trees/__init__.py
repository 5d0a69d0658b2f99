"""trees of the PyTorch/CUDA port (twin of ``repro.trees``)."""
