"""Losses: shared helpers, the plain SDF losses (2D and 3D), the MISO
mapping, tracking and fusion losses and the iSDF losses."""
