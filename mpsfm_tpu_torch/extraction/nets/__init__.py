"""Neural network architectures of the extraction model zoo (port of
mpsfm_tpu/extraction/nets/): so far Metric3Dv2 (metric3d.py) and the
resize and layer helpers it shares with DepthAnythingV2
(depth_anything.py)."""
