"""Serving steps over the port's models."""
