"""The port's version, stamped into every artifact header
(``obs/artifacts.py``). Kept equal to the JAX package's, whose tooling
reads both packages' artifacts."""

__version__ = "0.1.0"
