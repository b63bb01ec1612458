"""Data parallelism over ``torch.distributed`` (``core/mesh.py``)."""
