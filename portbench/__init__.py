"""The benchmark of the PyTorch / CUDA port (`humangaussian_torch`); see
README.md."""
