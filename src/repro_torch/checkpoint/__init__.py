"""Checkpoints of the PyTorch port (``checkpoint.manager``), in the
reference's on-disk layout."""
