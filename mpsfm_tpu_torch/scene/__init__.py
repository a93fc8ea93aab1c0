"""Scene state (port of mpsfm_tpu/scene); so far only the device functions
of the uncertainty chain."""
