"""Minimal dataclass builder (a copy of ``vip_tpu.objects._builder``, the
stand-in for the dataclass_builder package of VIP's objects layer)."""

from dataclasses import fields, MISSING

__all__ = ["dataclass_builder"]


def dataclass_builder(cls):
    """Return a builder class for dataclass ``cls``: set fields as
    attributes, call ``.build()`` to construct the dataclass."""

    class _Builder:
        _target = cls

        def __init__(self, **kwargs):
            self._values = dict(kwargs)

        def __setattr__(self, name, value):
            if name.startswith("_"):
                super().__setattr__(name, value)
            else:
                self._values[name] = value

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)
            try:
                return self._values[name]
            except KeyError:
                raise AttributeError(name)

        def build(self):
            valid = {f.name for f in fields(cls)}
            kwargs = {k: v for k, v in self._values.items() if k in valid}
            return cls(**kwargs)

    _Builder.__name__ = cls.__name__ + "Builder"
    _Builder.__qualname__ = _Builder.__name__
    return _Builder
