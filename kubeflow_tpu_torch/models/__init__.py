"""Models of the PyTorch port (serving slice: the transformer LM)."""
