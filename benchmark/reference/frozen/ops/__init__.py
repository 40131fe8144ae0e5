"""Frozen copy (see benchmark/reference/frozen/__init__.py)."""
