"""Extraction's seconds an image: the program's TIMERS phases pipe.extract_*
(pairs, features, matches, priors, masks; host clock, each ending with its
cache written from host arrays, so no device work of a phase outlives it;
the nets are built inside them, their loads included), summed over the
window's scenes, over the images handed to reconstruct."""


def read(run):
    images = sum(s["images"] for s in run.scenes)
    return sum(s["extract_s"] for s in run.scenes) / images if images else None
