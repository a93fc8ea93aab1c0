"""Geometry primitives (port of mpsfm_tpu/geometry)."""
