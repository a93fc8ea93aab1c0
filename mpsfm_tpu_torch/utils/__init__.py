"""Host utilities (port of part of mpsfm_tpu/utils): HDF5 cache IO, map
sampling, phase timers and device traces."""
