"""Hetero-SplitEE core of the port: losses and the serve step."""
