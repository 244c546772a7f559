"""Small helpers of the port: ``logger.RecursiveLogger``, ``dot``
(the strategy's Graphviz export) and ``graph_algorithms``."""
