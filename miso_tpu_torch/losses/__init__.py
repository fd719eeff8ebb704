"""Losses: shared helpers and the MISO mapping/tracking losses."""
