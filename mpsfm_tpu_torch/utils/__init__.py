"""Host utilities (port of part of mpsfm_tpu/utils): image and artifact IO
(PNG decoder, HDF5 and directory stores), COLMAP models, the cache writer
queue, map sampling, phase timers and device traces."""
