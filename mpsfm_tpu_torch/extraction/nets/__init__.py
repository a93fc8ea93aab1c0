"""Neural network architectures of the extraction model zoo (port of
mpsfm_tpu/extraction/nets/): Metric3Dv2 (metric3d.py), DSINE (dsine.py),
RoMa (roma.py), MASt3R (mast3r.py), the two-view and warp classes
(two_view.py, warp.py, on vit.py and dpt.py) and DepthAnythingV2 with the
resize and layer helpers the others share (depth_anything.py)."""
