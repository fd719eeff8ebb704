"""Meshing, SDF fields and reconstruction metrics."""
