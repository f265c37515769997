"""Config base machinery: dict -> typed dataclass trees with unknown-key checks.

Port of ``deepspeed_tpu/runtime/config_utils.py`` (pure Python, unchanged
in substance). Plays the role of the reference's pydantic
``DeepSpeedConfigModel`` (``runtime/config_utils.py:17``) using stdlib
dataclasses: every config node supports ``from_dict`` with strict
unknown-key detection, deprecated-key remapping, and ``"auto"`` passthrough
values.
"""

import dataclasses
from typing import Any, Dict, Mapping, Optional, Type, TypeVar, Union

T = TypeVar("T", bound="ConfigModel")

AUTO = "auto"


class ConfigError(ValueError):
    pass


def _is_auto(v: Any) -> bool:
    return isinstance(v, str) and v.lower() == AUTO


@dataclasses.dataclass
class ConfigModel:
    """Base for all config nodes. Subclasses are plain dataclasses."""

    #: maps old key -> new key (reference: ``DeepSpeedConfigModel`` deprecated fields)
    _deprecated: Dict[str, str] = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def field_names(cls):
        return {f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")}

    @classmethod
    def _migrate_legacy(cls, d: Dict[str, Any]) -> Dict[str, Any]:
        """Hook for structural legacy-key rewrites that a flat old->new
        rename cannot express (e.g. ``cpu_offload: true`` becoming a nested
        ``offload_optimizer`` node). Default: identity."""
        return d

    @classmethod
    def from_dict(cls: Type[T], d: Optional[Mapping[str, Any]], path: str = "") -> T:
        if d is None:
            d = {}
        if not isinstance(d, Mapping):
            raise ConfigError(f"Config node {path or cls.__name__} must be a mapping, got {type(d)}")
        d = dict(d)
        deprecated = getattr(cls, "_DEPRECATED_KEYS", {})
        for old, new in deprecated.items():
            if old in d:
                if new is not None and new not in d:
                    d[new] = d.pop(old)
                else:
                    d.pop(old)
        d = cls._migrate_legacy(d)
        names = cls.field_names()
        unknown = set(d) - names
        if unknown:
            raise ConfigError(f"Unknown config keys at {path or cls.__name__}: {sorted(unknown)}; "
                              f"valid keys: {sorted(names)}")
        kwargs = {}
        hints = {f.name: f for f in dataclasses.fields(cls)}
        for k, v in d.items():
            f = hints[k]
            sub = _subconfig_type(f.type)
            if sub is not None and isinstance(v, Mapping):
                v = sub.from_dict(v, path=f"{path}.{k}" if path else k)
            kwargs[k] = v
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            if f.name.startswith("_"):
                continue
            v = getattr(self, f.name)
            if isinstance(v, ConfigModel):
                v = v.to_dict()
            out[f.name] = v
        return out


_SUBCONFIG_REGISTRY: Dict[str, type] = {}


def register_config(cls):
    _SUBCONFIG_REGISTRY[cls.__name__] = cls
    return cls


def _subconfig_type(tp) -> Optional[type]:
    """Resolve a dataclass field annotation to a ConfigModel subclass if it is one."""
    if isinstance(tp, type) and issubclass(tp, ConfigModel):
        return tp
    if isinstance(tp, str):
        name = tp.strip()
        for tok in ("Optional[", "]", '"', "'"):
            name = name.replace(tok, "")
        return _SUBCONFIG_REGISTRY.get(name)
    # typing.Optional[X]
    args = getattr(tp, "__args__", None)
    if args:
        for a in args:
            r = _subconfig_type(a)
            if r is not None:
                return r
    return None


def get_scalar(v: Any, default: Any) -> Any:
    """Resolve an ``"auto"`` config value to a default."""
    return default if _is_auto(v) or v is None else v
