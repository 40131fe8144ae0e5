"""Data parallelism over torch.distributed ranks (``mesh.py``)."""
