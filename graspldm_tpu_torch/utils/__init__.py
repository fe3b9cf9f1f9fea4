"""Rotation, normalization, point-cloud and weight-bridge helpers."""
