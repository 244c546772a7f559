"""RecursiveLogger: depth-indented search/trace logging.

The port's own copy of ``flexflow_tpu/utils/logger.py``, the analog of
the original FlexFlow's ``recursive_logger.h``: each line is tagged with
its recursion depth ("[depth] message") so nested decisions read as a
tree. ``--profiling`` prints its per-op table through it.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Optional, TextIO


class RecursiveLogger:
    def __init__(self, name: str = "search", stream: Optional[TextIO] = None,
                 enabled: bool = True):
        self.name = name
        self.stream = stream or sys.stderr
        self.enabled = enabled
        self.depth = 0

    @contextlib.contextmanager
    def enter(self, tag: str = ""):
        """Nested scope: lines inside are indented one level deeper."""
        if tag:
            self.info(tag)
        self.depth += 1
        try:
            yield self
        finally:
            self.depth -= 1

    def info(self, msg: str) -> None:
        if self.enabled:
            self.stream.write(f"[{self.name}] [{self.depth}] "
                              + "  " * self.depth + msg + "\n")

    def spew(self, msg: str) -> None:  # the finer level
        self.info(msg)
