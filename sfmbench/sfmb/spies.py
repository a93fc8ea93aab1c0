"""Wrappers the harness puts around named functions of the program: they
call the function as before and hand its arguments and result to a
recorder. The counting files (counts/*.py, TARGET) and the configuration's
`calls` name the functions; nothing else of the program is touched."""

from __future__ import annotations

import importlib


class Spy:
    """`module`'s attribute path `attr` ("f" or "Class.f") wrapped while
    installed: on_call(args, kwargs, result) after each call."""

    def __init__(self, module, attr, on_call):
        owner = importlib.import_module(module)
        *path, self.name = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        self.owner, self.on_call = owner, on_call
        self.orig = owner.__dict__[self.name]

    def __enter__(self):
        orig, on_call = self.orig, self.on_call

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            on_call(args, kwargs, out)
            return out

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)
        return False


def targets(entry):
    """The (module, attr) pairs of one entry of a configuration's `calls`:
    one pair, a list of them where callers bound the function under their
    own names (all feed one recorder), or {"targets": either, "keep": n,
    "first": m}."""
    if isinstance(entry, dict):
        entry = entry["targets"]
    return [tuple(entry)] if isinstance(entry[0], str) else [tuple(e) for e in entry]


def keeper(entry):
    """The recorder of one entry of `calls`: its last call, or its last
    `keep` calls and its first `first`."""
    if not isinstance(entry, dict):
        return LastCall()
    return LastCall(entry.get("keep", 1), entry.get("first", 0))


class LastCall:
    """Keeps the arguments and result of the first `first` and the last
    `keep` calls (references, no copy): the program makes these tensors
    afresh each call."""

    def __init__(self, keep=1, first=0):
        self.keep, self.first = keep, first
        self.head, self.calls = [], []

    def __call__(self, args, kwargs, out):
        if len(self.head) < self.first:
            self.head.append((args, out))
        else:
            self.calls = (self.calls + [(args, out)])[-self.keep:]

    def take(self):
        """The kept calls, oldest first (none: an empty list)."""
        calls = self.head + self.calls
        self.head, self.calls = [], []
        return calls
