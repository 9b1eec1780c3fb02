"""Synthetic networked datasets (counterpart of ``repro.data``)."""
