"""data of the PyTorch/CUDA port (twin of ``repro.data``)."""
