"""A step that returns its state unchanged: K2's PCG returns its start
without one iteration."""

import importlib

import torch

from sfmb.spies import Spy


class _Plant(Spy):
    def __enter__(self):
        def unchanged(st, b, dg, x0, max_iter, tol, active, *a, **k):
            return x0.clone(), torch.zeros(x0.shape[0], dtype=torch.int32, device=x0.device)

        setattr(self.owner, self.name, unchanged)
        return self


def plant():
    importlib.import_module("mpsfm_tpu_torch.integration.bini")
    return _Plant("mpsfm_tpu_torch.integration.bini", "_pcg", None)
