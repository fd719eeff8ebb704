"""Models: GridNet and the parameter-mask helpers."""
