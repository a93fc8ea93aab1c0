"""The mapper (port of mpsfm_tpu/mapper)."""
