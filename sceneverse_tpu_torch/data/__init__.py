"""Datasets of the port (its own copies; see ``data/build.py``)."""
