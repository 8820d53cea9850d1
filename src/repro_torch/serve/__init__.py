"""Batch serving engine of the port."""
