"""Submap alignment (port of ``miso_tpu/align``): MISO hierarchical latent alignment."""
