"""Checkpointing, metric logging and the shared response codes."""
