"""Core of the port: config, partitioning, the stacked worker axis and its
collectives, the feature cache and the distributed subgraph generator."""
