"""An answer altered where it is produced: LightGlue's match extraction
points every tenth matched keypoint at the next keypoint of the other
image."""

import torch

from sfmb.spies import Spy


class _Plant(Spy):
    def __enter__(self):
        orig = self.orig

        def shifted(scores, m0, m1, threshold):
            mm, ss = orig(scores, m0, m1, threshold)
            n1 = m1.sum(1, keepdim=True).to(mm.dtype)
            idx = torch.arange(mm.shape[1], device=mm.device)[None]
            hit = (mm >= 0) & (idx % 10 == 0)
            return torch.where(hit, (mm + 1) % n1.clamp(min=1), mm), ss

        setattr(self.owner, self.name, shifted)
        return self


def plant():
    return _Plant("mpsfm_tpu_torch.extraction.matchers.lightglue", "device_extract", None)
