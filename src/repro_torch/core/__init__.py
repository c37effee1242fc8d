"""Core of the port: config, partitioning, the worker groups (the stacked
axis and one process per worker) and their collectives, the feature
cache and the distributed subgraph generator."""
