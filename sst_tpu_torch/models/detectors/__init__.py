"""Detectors of the port."""
