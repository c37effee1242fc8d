"""Training substrate of the port: the optimizer, the workers' gradient
sync, checkpoints and failure recovery."""
