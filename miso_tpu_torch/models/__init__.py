"""Models: GridNet (regular, 2D and VM grids), GridAtlas, the encoder, the
alternative models (``hashgrid.HashGridNet``, ``isdf.ISDF``,
``pointsdf.PointSDF``) and the parameter-mask helpers."""
