"""Entry points of the PyTorch port: serving (``python -m
repro_torch.launch.serve``) and training (``python -m
repro_torch.launch.train``)."""
