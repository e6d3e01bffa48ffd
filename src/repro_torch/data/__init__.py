"""Synthetic graph generators (a numpy copy of ``repro.data.graphs``)."""
