"""Submap alignment (port of ``miso_tpu/align``): MISO hierarchical latent
alignment (``miso``) and the VoxFusion++, MIPS-Fusion and ICP baselines
(``baselines``)."""
