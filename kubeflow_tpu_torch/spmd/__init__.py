"""The gang's mesh on the PyTorch port: a placement's derivation (``derive``,
from the port's copy of the TPU topology table) and its mesh as the port's
``MeshPlan`` and ``DeviceMesh``."""
