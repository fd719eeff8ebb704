"""Datasets: host-side numpy samplers of fixed-shape batches."""
