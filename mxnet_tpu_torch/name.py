"""NameManager — automatic symbol naming (python/mxnet/name.py)."""
from __future__ import annotations

import threading

__all__ = ["NameManager"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager

    @staticmethod
    def current():
        cur = getattr(NameManager._current, "value", None)
        if cur is None:
            cur = NameManager()
            NameManager._current.value = cur
        return cur

