"""The mapper's result against the truth: the rotations of the window's
scenes (rendered by sfmb/scenes.py, whose camera path is known), as the
program's reconstructions pose their registered images. A reconstruction
is defined up to a similarity, so each pair of registered images is
compared by its relative rotation.
"""

from __future__ import annotations

import itertools
import math

import numpy as np


def angle_deg(R):
    return math.degrees(math.acos(float(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def direction_deg(u, v):
    u, v = u / max(np.linalg.norm(u), 1e-300), v / max(np.linalg.norm(v), 1e-300)
    return math.degrees(math.acos(float(np.clip(u @ v, -1.0, 1.0))))


def scene_error(rec):
    """(largest relative-rotation error over the pairs of the scene's
    registered images, largest baseline-direction error) in degrees."""
    truth, got = rec["scene"]["truth"], rec["poses"]
    rot, dirs = 0.0, 0.0
    for a, b in itertools.combinations(sorted(got), 2):
        (Ra, ta), (Rb, tb) = got[a], got[b]
        (Qa, sa), (Qb, sb) = truth[a], truth[b]
        rot = max(rot, angle_deg((Rb @ Ra.T) @ (Qb @ Qa.T).T))
        # b's centre seen from a, in a's frame
        dirs = max(dirs, direction_deg(Ra @ (-Rb.T @ tb) + ta, Qa @ (-Qb.T @ sb) + sa))
    return rot, dirs


def compare(ctx):
    """pose_err_deg: the smallest, over the window's scenes in which two or
    more images registered, of the scene's largest relative-rotation error;
    no such scene reads infinite. The smallest, and not one scene's: under
    the seeded nets a scene's descriptors and priors carry nothing of its
    geometry, so some textures lead the mapper to a wrong one, while a
    fault of the mapper, its bundle adjustment or its kernels turns every
    scene."""
    errs = []
    for i, rec in enumerate(ctx.window):
        if not rec.get("finished") or len(rec.get("poses", {})) < 2:
            ctx.note(f"poses: window scene {i} registered {rec.get('registered', 0)} image(s)")
            continue
        rot, dirs = scene_error(rec)
        ctx.note(f"poses: window scene {i} registered {len(rec['poses'])} of {len(rec['scene']['truth'])}, "
                 f"rotation {rot:.4f} deg, baseline direction {dirs:.4f} deg")
        errs.append(rot)
    return {"pose_err_deg": min(errs) if errs else float("inf")}
