"""``ray_tpu_torch/_private/pickler.py``: what cloudpickle carries for the
JAX package's runtime, the port's pickler carries with the standard
library. Functions and classes a worker could not import (``<locals>``
here, ``__main__`` in a script) round-trip by value; importable ones go by
reference, byte for byte as ``pickle`` writes them."""

import pickle
import types

import numpy as np
import pytest

from ray_tpu_torch._private import pickler


def _roundtrip(obj):
    return pickler.loads(pickler.dumps(obj))


def _closure_case():
    base = 10

    def add(x, y=2, *, z=3):
        return base + x + y + z

    return add, lambda f: f(1) == 16 and f(1, 0, z=0) == 11


def _recursive_case():
    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    return fact, lambda f: f(6) == 720


def _global_module_case():
    return (lambda x: float(np.sum(np.arange(x)))), lambda f: f(5) == 10.0


def _class_case():
    class Base:
        def __init__(self, n):
            self.n = n

        def value(self):
            return self.n

    class Child(Base):
        scale = 3

        def value(self):
            return super().value() * self.scale

        @property
        def twice(self):
            return 2 * self.value()

        @classmethod
        def make(cls, n):
            return cls(n)

        @staticmethod
        def unit():
            return 1

    def check(cls):
        c = cls.make(4)
        return (c.value(), c.twice, cls.unit(), cls.__name__,
                cls.__mro__[1].__name__) == (12, 24, 1, "Child", "Base")

    return Child, check


@pytest.mark.parametrize("case", [_closure_case, _recursive_case,
                                  _global_module_case, _class_case],
                         ids=["closure", "recursive", "module-global",
                              "class"])
def test_unimportable_objects_roundtrip_by_value(case):
    obj, check = case()
    with pytest.raises((pickle.PicklingError, AttributeError, TypeError)):
        pickle.dumps(obj)
    back = _roundtrip(obj)
    assert back is not obj
    assert check(back)


def test_instance_of_a_local_class_keeps_its_state():
    cls, _ = _class_case()
    back = _roundtrip(cls(5))
    assert back.value() == 15 and type(back).__name__ == "Child"


def test_importable_objects_go_by_reference():
    for obj in (np.arange, pickle.dumps, types.SimpleNamespace,
                pickler.Pickler):
        assert pickler.dumps(obj) == pickle.dumps(obj, protocol=5)
        assert _roundtrip(obj) is obj
    assert _roundtrip(np) is np
