"""Entry points of the PyTorch port: serving (``python -m
repro_torch.launch.serve``)."""
