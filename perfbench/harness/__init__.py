"""The benchmark harness of the PyTorch and CUDA port (``perfbench/``)."""
