"""Data layer: corpus datasets and fixed-shape host batching."""
