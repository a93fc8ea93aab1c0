"""Half of the batch left out: K4 computes the first half of its batch
elements and repeats their mean over the rest."""

import torch

from sfmb.spies import Spy


class _Plant(Spy):
    def __enter__(self):
        orig = self.orig

        def half(q, k, v, mask, scale, *a, **kw):
            B = q.shape[0]
            h = max(1, B // 2)
            out = orig(q[:h], k[:h], v[:h], mask[:h], scale, *a, **kw)
            rest = out.float().mean(0, keepdim=True).to(out.dtype).expand(B - h, *out.shape[1:])
            return torch.cat([out, rest]) if B > h else out

        setattr(self.owner, self.name, half)
        return self


def plant():
    return _Plant("mpsfm_tpu_torch.extraction.matchers.attention", "_forward", None)
