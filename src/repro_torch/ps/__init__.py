"""ps of the PyTorch/CUDA port (twin of ``repro.ps``)."""
