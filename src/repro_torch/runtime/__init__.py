"""Serving runtime of the port (`classify.ClassifyServer`)."""
