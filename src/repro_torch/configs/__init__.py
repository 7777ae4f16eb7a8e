"""The model zoo's configurations: the schema (``base``), the registry
(``registry``) and one module per architecture with its published
figures (``FULL``) and a smoke-test variant (``SMOKE``)."""
