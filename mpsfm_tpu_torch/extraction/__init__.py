"""Extraction (port of the main path's part of mpsfm_tpu/extraction):
image pairs, classical features, mutual-NN matches and measured priors,
cached by image and pair name."""
