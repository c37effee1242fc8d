"""Training substrate of the port: the optimizer."""
