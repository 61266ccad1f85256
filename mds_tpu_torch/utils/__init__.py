"""Logging, progress meters and the metrics sink of the port."""
