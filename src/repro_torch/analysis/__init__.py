"""Analytic roofline helpers for the port (H100 constants)."""
