"""Optimizers of the PyTorch port: AdamW (``optim.adamw``)."""
