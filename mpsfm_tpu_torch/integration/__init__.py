"""Depth-map integration (port of mpsfm_tpu/integration)."""
