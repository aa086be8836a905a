"""The notebook runtime of the PyTorch port: host-to-device prefetch, checkpoint and resume, profiling."""
