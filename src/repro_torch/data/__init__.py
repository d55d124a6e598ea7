"""Data pipelines."""
