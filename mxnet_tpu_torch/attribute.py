"""AttrScope — scoped symbol attributes (python/mxnet/attribute.py).

Carries attributes like ``ctx_group`` (model parallelism) onto symbols
composed inside the scope.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("Attributes need to be string")
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr):
        """Merge scope attrs with user-provided ``attr`` dict."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = getattr(AttrScope._current, "value", None)
        attr = (self._old_scope._attr.copy() if self._old_scope else {})
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        cur = getattr(AttrScope._current, "value", None)
        return cur if cur is not None else AttrScope()
