"""Bundle adjustment (port of mpsfm_tpu/ba)."""
