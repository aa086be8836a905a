"""Training-step builders of the PyTorch port (one device; meshes come with slice 5)."""
