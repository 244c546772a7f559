"""Strategy search: in this slice, the strategy-file import that carries
per-op kernel choices (``search/unity.py``); the search itself comes with
the search slice of the PyTorch port (slice 3)."""
