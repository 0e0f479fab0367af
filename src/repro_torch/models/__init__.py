"""Models of the port: the LM transformer, inference half."""
