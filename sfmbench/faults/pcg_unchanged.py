"""A step that returns its state unchanged: K3's PCG returns its coarse
start (the deflated guess) without one iteration."""

import importlib

from sfmb.spies import Spy


class _Plant(Spy):
    def __enter__(self):
        orig = self.orig

        def no_iterations(st, dfl, rows, cols, iters, *a, **k):
            return orig(st, dfl, rows, cols, 0, *a, **k)

        setattr(self.owner, self.name, no_iterations)
        return self


def plant():
    importlib.import_module("mpsfm_tpu_torch.integration.bini")
    return _Plant("mpsfm_tpu_torch.integration.bini", "deflated_pcg", None)
