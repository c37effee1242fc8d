"""Models of the port (the paper's GCN and the dense LM)."""
