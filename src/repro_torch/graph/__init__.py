"""Graph layer of the port: CSR, synthetic power-law graphs and the padded
subgraph batch."""
