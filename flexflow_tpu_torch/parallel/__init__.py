"""Parallel execution: ring attention over a sequence axis.

PyTorch counterpart of ``flexflow_tpu/parallel`` (this slice ports
``ring_attention``; ROADMAP.md lists the rest).
"""
