"""Training substrate of the port: the optimizer, checkpoints and failure
recovery."""
