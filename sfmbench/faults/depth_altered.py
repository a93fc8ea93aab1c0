"""An answer altered where it is produced: the depth prior's net scales its
depth by 1.01."""

from sfmb.spies import Spy


class _Plant(Spy):
    def __enter__(self):
        orig = self.orig

        def scaled(self_, *a, **k):
            out = orig(self_, *a, **k)
            out["depth"] = out["depth"] * 1.01
            return out

        setattr(self.owner, self.name, scaled)
        return self


def plant():
    return _Plant("mpsfm_tpu_torch.extraction.nets.metric3d", "Metric3Dv2.infer_image", None)
