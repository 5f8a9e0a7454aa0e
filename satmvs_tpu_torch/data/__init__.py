"""Synthetic scenes and batches."""
