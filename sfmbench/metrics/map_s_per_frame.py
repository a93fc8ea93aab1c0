"""The mapper's seconds a registered image: each scene's wall (ending in a
device synchronise) less its pipe.extract_* phases (correspondences,
priors, mapping, outputs), summed over the window's scenes, over the images
registered. Host-paced."""


def read(run):
    reg = sum(s["registered"] for s in run.scenes)
    return sum(s["wall_s"] - s["extract_s"] for s in run.scenes) / reg if reg else None
