"""Field ops: interpolation, SE(3), MLP, spatial gradients, fused decode."""
