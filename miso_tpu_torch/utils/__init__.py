"""Meshing, SDF fields and sphere tracing, ray sampling, reconstruction
metrics and ICP, profiling, and the ScanNet and Newer College eval helpers."""
