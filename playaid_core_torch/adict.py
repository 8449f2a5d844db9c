"""Attribute-access auto-nesting dictionary.

The port's own copy of ``playaid_core_tpu/adict.py``.

The reference framework leans on the ``addict`` package for its stats
accumulators and frame-data records (reference: stats.py:3, frame_data.py:1).
``addict`` is not available in this environment, so this module provides a
behavior-compatible implementation.  The semantics that matter for parity:

* missing key/attribute access returns an **empty child Dict** without
  inserting it (no read side effects);
* assignment through a chain of missing keys materialises the chain
  (``d.a.b.c = 1`` creates ``a`` and ``b``);
* ``Dict() + x == x`` so ``d.counter[k] += 1`` works on first touch;
* an empty Dict is falsy, so ``d.get(...) or 0`` patterns work;
* ``to_dict()`` recursively converts to plain ``dict``.
"""

from __future__ import annotations

import copy


class Dict(dict):
    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "__parent", kwargs.pop("__parent", None))
        object.__setattr__(self, "__key", kwargs.pop("__key", None))
        for arg in args:
            if not arg:
                continue
            elif isinstance(arg, dict):
                for key, val in arg.items():
                    self[key] = self._hook(val)
            elif isinstance(arg, tuple) and (not isinstance(arg[0], tuple)):
                self[arg[0]] = self._hook(arg[1])
            else:
                for key, val in iter(arg):
                    self[key] = self._hook(val)
        for key, val in kwargs.items():
            self[key] = self._hook(val)

    def __setattr__(self, name, value):
        if hasattr(self.__class__, name):
            raise AttributeError(f"'Dict' object attribute '{name}' is read-only")
        self[name] = value

    def __setitem__(self, name, value):
        super().__setitem__(name, value)
        # Materialise the chain of parents that produced this (previously
        # missing) node.
        try:
            p = object.__getattribute__(self, "__parent")
            key = object.__getattribute__(self, "__key")
        except AttributeError:
            p, key = None, None
        if p is not None:
            p[key] = self
            object.__setattr__(self, "__parent", None)
            object.__setattr__(self, "__key", None)

    def __add__(self, other):
        if not self.keys():
            return other
        raise TypeError("Dict is not empty; cannot add")

    def __radd__(self, other):
        if not self.keys():
            return other
        raise TypeError("Dict is not empty; cannot add")

    @classmethod
    def _hook(cls, item):
        if isinstance(item, dict) and not isinstance(item, Dict):
            return cls(item)
        elif isinstance(item, (list, tuple)):
            return type(item)(cls._hook(elem) for elem in item)
        return item

    def __getattr__(self, item):
        return self.__getitem__(item)

    def __missing__(self, name):
        return self.__class__(__parent=self, __key=name)

    def __delattr__(self, name):
        del self[name]

    def to_dict(self):
        base = {}
        for key, value in self.items():
            if isinstance(value, type(self)):
                base[key] = value.to_dict()
            elif isinstance(value, (list, tuple)):
                base[key] = type(value)(
                    item.to_dict() if isinstance(item, type(self)) else item
                    for item in value
                )
            else:
                base[key] = value
        return base

    def copy(self):
        return copy.copy(self)

    def deepcopy(self):
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        other = self.__class__()
        memo[id(self)] = other
        for key, value in self.items():
            other[copy.deepcopy(key, memo)] = copy.deepcopy(value, memo)
        return other

    def setdefault(self, key, default=None):
        if key in self:
            return self[key]
        self[key] = default
        return default
