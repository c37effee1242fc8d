"""Launchers of the port (the graph-serving tier)."""
