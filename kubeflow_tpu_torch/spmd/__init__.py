"""The gang's mesh build on the PyTorch port: a placement's derived mesh as the port's ``MeshPlan`` and ``DeviceMesh``."""
