"""Neural network architectures of the extraction model zoo (port of
mpsfm_tpu/extraction/nets/): Metric3Dv2 (metric3d.py), DSINE (dsine.py),
RoMa (roma.py) and the resize and layer helpers they share with
DepthAnythingV2 (depth_anything.py)."""
