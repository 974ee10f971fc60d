"""Port of ``g2o_tpu/utils/properties.py`` (plain Python, as there).

String-keyed typed properties — analogue of the reference
``Property<T>``/``PropertyMap`` (``g2o/stuff/property.h:41-159``), used to
expose tunable solver knobs (``OptimizationAlgorithm::properties``,
``optimization_algorithm.h:98-110``) and the CLI's ``-solverProperties``
``k1=v1,k2=v2`` strings."""

from __future__ import annotations


class Property:
    def __init__(self, name: str, value):
        self.name = name
        self._value = value

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        self._value = type(self._value)(v) if self._value is not None else v


class PropertyMap(dict):
    """dict of name -> Property with typed string updates."""

    def make_property(self, name: str, default):
        p = Property(name, default)
        self[name] = p
        return p

    def get_value(self, name: str, default=None):
        p = self.get(name)
        return p.value if p is not None else default

    def set_value(self, name: str, value) -> bool:
        p = self.get(name)
        if p is None:
            return False
        p.value = value
        return True

    def update_from_string(self, spec: str) -> int:
        """Parse ``k1=v1,k2=v2`` (reference ``updateMapFromString``).
        Returns the number of properties updated; unknown keys raise."""
        n = 0
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"malformed property {item!r} (need k=v)")
            k, v = item.split("=", 1)
            if k not in self:
                raise KeyError(f"unknown property {k!r}; known: "
                               f"{sorted(self)}")
            self[k].value = v
            n += 1
        return n

    def __str__(self):
        return ", ".join(f"{k}={p.value}" for k, p in sorted(self.items()))
