"""Meshes, sharding rules, the distributed bootstrap and the train-step factories of the PyTorch port."""
