"""The in-pod telemetry agent's PyTorch backends: device memory, kernel compiles, trace capture."""
