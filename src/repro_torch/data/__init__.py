"""Synthetic data and the host-side data pipeline of the port (counterpart
of ``repro/data``)."""
