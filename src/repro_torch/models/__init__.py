"""Model code of the PyTorch port: parameter declaration (``param``) and
the shared layers (``layers``)."""
