"""Model code of the PyTorch port: parameter declaration (``param``),
the shared layers (``layers``), attention (``attention``), the mixers
(``mla``, ``moe``, ``rwkv6``, ``rglru``), the decoder that strings them
together (``transformer``) and the public model API (``model_zoo``)."""
