"""Config model base.

Port of ``deepspeed_tpu/runtime/config_utils.py``, which is a pydantic model.
The port has no pydantic, so a config block is a plain ``@dataclass`` that
inherits :class:`DeepSpeedConfigModel`. What the pydantic base did and the
port keeps:

- nested blocks may be given as dicts and are built into their dataclass;
- enum fields accept their value (``"allocate"``) as well as the member;
- fields declared with :func:`config_field` take an ``alias`` (used by
  :meth:`DeepSpeedConfigModel.from_dict`) and ``gt``/``ge``/``lt``/``le`` bounds,
  which a None value skips;
- ``Literal`` fields accept only their listed values, and a list given for a
  ``Tuple`` field is stored as a tuple;
- ``from_dict`` drops ``"auto"`` values so the defaults apply.
"""

import dataclasses
import enum
import typing
from dataclasses import MISSING


def config_field(default=MISSING, *, default_factory=MISSING, alias=None, gt=None, ge=None, lt=None, le=None):
    return dataclasses.field(default=default, default_factory=default_factory,
                             metadata={"alias": alias, "gt": gt, "ge": ge, "lt": lt, "le": le})


class DeepSpeedConfigModel:
    """Mixin for ``@dataclass`` config blocks (see the module docstring)."""

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            typ = hints.get(f.name)
            if typing.get_origin(typ) is typing.Union:  # Optional[X]: build X unless None
                args = [a for a in typing.get_args(typ) if a is not type(None)]
                typ = args[0] if len(args) == 1 and value is not None else None
            if isinstance(typ, type):
                if dataclasses.is_dataclass(typ) and isinstance(value, dict):
                    value = typ.from_dict(value)
                elif issubclass(typ, enum.Enum) and not isinstance(value, typ):
                    value = typ(value)
                setattr(self, f.name, value)
            elif typing.get_origin(typ) is typing.Literal and value not in typing.get_args(typ):
                raise ValueError(f"{type(self).__name__}.{f.name}={value!r} must be one of "
                                 f"{typing.get_args(typ)}")
            elif typing.get_origin(typ) is tuple and isinstance(value, list):
                setattr(self, f.name, tuple(value))
            if value is None:
                continue
            gt, ge, lt, le = (f.metadata.get(k) for k in ("gt", "ge", "lt", "le"))
            if gt is not None and not value > gt:
                raise ValueError(f"{type(self).__name__}.{f.name}={value!r} must be > {gt}")
            if ge is not None and not value >= ge:
                raise ValueError(f"{type(self).__name__}.{f.name}={value!r} must be >= {ge}")
            if lt is not None and not value < lt:
                raise ValueError(f"{type(self).__name__}.{f.name}={value!r} must be < {lt}")
            if le is not None and not value <= le:
                raise ValueError(f"{type(self).__name__}.{f.name}={value!r} must be <= {le}")

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
