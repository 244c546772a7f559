"""Small helpers of the port (``logger.RecursiveLogger``)."""
