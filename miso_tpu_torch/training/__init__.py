"""Pretraining drivers (port of the repository's ``training/`` scripts)."""
