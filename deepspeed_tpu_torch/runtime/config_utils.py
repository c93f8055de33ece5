"""Config model base.

Port of ``deepspeed_tpu/runtime/config_utils.py``, which is a pydantic model.
The port has no pydantic, so a config block is a plain ``@dataclass`` that
inherits :class:`DeepSpeedConfigModel`. What the pydantic base did and the
port keeps:

- nested blocks may be given as dicts and are built into their dataclass;
- enum fields accept their value (``"allocate"``) as well as the member;
- fields declared with :func:`config_field` take an ``alias`` (used by
  :meth:`DeepSpeedConfigModel.from_dict`) and ``gt``/``ge`` bounds;
- ``from_dict`` drops ``"auto"`` values so the defaults apply.
"""

import dataclasses
import enum
import typing
from dataclasses import MISSING


def config_field(default=MISSING, *, default_factory=MISSING, alias=None, gt=None, ge=None):
    return dataclasses.field(default=default, default_factory=default_factory,
                             metadata={"alias": alias, "gt": gt, "ge": ge})


class DeepSpeedConfigModel:
    """Mixin for ``@dataclass`` config blocks (see the module docstring)."""

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            typ = hints.get(f.name)
            if isinstance(typ, type):
                if dataclasses.is_dataclass(typ) and isinstance(value, dict):
                    value = typ.from_dict(value)
                elif issubclass(typ, enum.Enum) and not isinstance(value, typ):
                    value = typ(value)
                setattr(self, f.name, value)
            gt, ge = f.metadata.get("gt"), f.metadata.get("ge")
            if gt is not None and not value > gt:
                raise ValueError(f"{type(self).__name__}.{f.name}={value!r} must be > {gt}")
            if ge is not None and not value >= ge:
                raise ValueError(f"{type(self).__name__}.{f.name}={value!r} must be >= {ge}")

    @classmethod
    def from_dict(cls, data: dict):
        """Build from a (JSON-style) dict; keys may be field names or aliases."""
        names = {}
        for f in dataclasses.fields(cls):
            names[f.name] = f.name
            if f.metadata.get("alias"):
                names[f.metadata["alias"]] = f.name
        kwargs = {}
        for key, value in data.items():
            if isinstance(value, str) and value == "auto":
                continue
            if key not in names:
                raise ValueError(f"{cls.__name__} has no field {key!r}")
            kwargs[names[key]] = value
        return cls(**kwargs)
