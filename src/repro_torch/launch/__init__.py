"""Launchers of the port: training, the graph-serving tier, the
autotuner, and the worker groups and their process launcher."""
