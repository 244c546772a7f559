"""Strategy search: the Unity search and strategy files
(``search/unity.py``, the native core ``search/native.py``, the graph
rewrites ``search/rewrite.py``), per-op timing on the device that prices
it under ``--search-measure-ops`` (``search/profile.py``), and the
priced-vs-emitted validation (``search/validate.py``)."""
