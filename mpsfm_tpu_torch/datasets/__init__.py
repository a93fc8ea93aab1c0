"""Scene parsers (port of mpsfm_tpu/datasets)."""
