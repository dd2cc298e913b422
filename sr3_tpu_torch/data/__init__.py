"""Training data batching of the port (``loader.py``)."""
