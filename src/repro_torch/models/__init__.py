"""Models of the port: the LM transformer (serving, training, sharding),
the four GNNs and DIN."""
