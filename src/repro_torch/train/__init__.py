"""Training substrate of the port: the optimizer, the LM step builder and
the workers' gradient sync, the int8 gradient compression, checkpoints
and failure recovery."""
