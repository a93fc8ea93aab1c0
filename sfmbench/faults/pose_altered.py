"""An answer altered where it is produced: the mapper hands back its
reconstruction with the last registered image turned by 10 degrees about
its camera's y axis (its centre kept)."""

import math

import numpy as np

from sfmb.spies import Spy

TURN = math.radians(10.0)


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


class _Plant(Spy):
    def __enter__(self):
        orig = self.orig

        def turned(self_, *a, **k):
            rec, ok = orig(self_, *a, **k)
            reg = sorted(i for i, im in rec.images.items() if im.registered)
            if reg:
                pose = rec.images[reg[-1]].pose
                qy = np.array([math.cos(TURN / 2), 0.0, math.sin(TURN / 2), 0.0])
                Ry = np.array([[math.cos(TURN), 0, math.sin(TURN)], [0, 1, 0], [-math.sin(TURN), 0, math.cos(TURN)]])
                pose.q, pose.t = _qmul(qy, np.asarray(pose.q, np.float64)), Ry @ np.asarray(pose.t, np.float64)
            return rec, ok

        setattr(self.owner, self.name, turned)
        return self


def plant():
    return _Plant("mpsfm_tpu_torch.mapper", "MpsfmMapper.__call__", None)
