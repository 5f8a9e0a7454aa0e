"""Geometry, sampling, cost-volume and regression ops."""
