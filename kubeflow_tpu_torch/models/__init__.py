"""Models of the PyTorch port: the transformer LM, its decoding loop and its losses."""
