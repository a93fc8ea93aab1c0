"""Half of the batch left out: LightGlue's match extraction drops every
match of the second half of each batch of pairs (of a lone pair, of its
keypoints' second half)."""

import torch

from sfmb.spies import Spy


class _Plant(Spy):
    def __enter__(self):
        orig = self.orig

        def halved(scores, m0, m1, threshold):
            mm, ss = orig(scores, m0, m1, threshold)
            B, N0 = mm.shape
            if B > 1:
                drop = (torch.arange(B, device=mm.device) >= (B + 1) // 2)[:, None].expand(B, N0)
            else:
                drop = torch.arange(N0, device=mm.device)[None] >= (m0.sum(1, keepdim=True) + 1) // 2
            return torch.where(drop, torch.full_like(mm, -1), mm), torch.where(drop, torch.zeros_like(ss), ss)

        setattr(self.owner, self.name, halved)
        return self


def plant():
    return _Plant("mpsfm_tpu_torch.extraction.matchers.lightglue", "device_extract", None)
