"""Runtime observability. This slice carries the counter registry that the
serving path writes to (``obs/registry.py``)."""
