"""Data of the PyTorch port: the synthetic deterministic pipeline
(``pipeline``)."""
