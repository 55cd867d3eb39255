"""Dataclass-backed configuration with CLI-flag and JSON-file overrides.

A copy of ``dsml_tpu.utils.config`` (pure Python), kept here so that the
port imports nothing of the JAX package.

The reference has *no* config layer at all — every knob is a hard-coded
constant (ports in ``DSML/cmd/gpu_device_server/main.go:13-23``, hyperparams
in ``DSML/client/client.go:22-33``, health interval in
``gpu_coordinator_service/gpu_coordinator_server.go:57``; see SURVEY.md §5.6).
This module closes that gap: every process in dsml_tpu_torch (device host,
coordinator, trainer) is configured through a ``Config`` subclass that can be

- constructed programmatically (tests),
- overridden from CLI flags (``--lr 0.01 --mesh.dp 4``), and
- loaded from a JSON file (``--config path.json``).

Nested configs use dotted flag names. Types are enforced from the dataclass
annotations; ``bool`` flags accept true/false/1/0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import typing
from dataclasses import field as _dc_field
from typing import Any, Sequence

__all__ = ["Config", "field", "parse_cli", "ConfigError", "env_float", "env_int"]


def env_float(name: str, default: float) -> float:
    """``float(os.environ[name])`` with the default on unset/garbage — the
    shared parser behind the ``DSML_*`` runtime knobs (stream TTL/stall,
    migration deadlines); one implementation so a parsing fix cannot
    diverge between subsystems."""
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def env_int(name: str, default: int) -> int:
    """Integer twin of :func:`env_float`."""
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def field(default=dataclasses.MISSING, *, default_factory=dataclasses.MISSING, help: str = ""):
    """Dataclass field with an attached ``help`` string for CLI usage text."""
    kwargs: dict[str, Any] = {"metadata": {"help": help}}
    if default is not dataclasses.MISSING:
        kwargs["default"] = default
    if default_factory is not dataclasses.MISSING:
        kwargs["default_factory"] = default_factory
    return _dc_field(**kwargs)


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class Config:
    """Base class for all dsml_tpu_torch configs. Subclass with typed fields."""

    # ---- construction helpers -------------------------------------------------

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        """Build a config from a (possibly nested) plain dict."""
        kwargs = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in d.items():
            if key not in fields:
                raise ConfigError(f"{cls.__name__}: unknown config key {key!r}")
            ftype = _resolve_type(cls, fields[key])
            if isinstance(ftype, type) and issubclass(ftype, Config) and isinstance(value, dict):
                value = ftype.from_dict(value)
            kwargs[key] = value
        return cls(**kwargs)

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    # ---- overrides ------------------------------------------------------------

    def override(self, dotted: str, raw: Any) -> None:
        """Set ``a.b.c`` to ``raw`` (string values are coerced to field type)."""
        obj: Any = self
        parts = dotted.split(".")
        for p in parts[:-1]:
            if not (dataclasses.is_dataclass(obj) and hasattr(obj, p)):
                raise ConfigError(f"unknown config path {dotted!r} (at {p!r})")
            obj = getattr(obj, p)
        if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
            raise ConfigError(f"unknown config path {dotted!r} (not a nested config)")
        leaf = parts[-1]
        fields = {f.name: f for f in dataclasses.fields(obj)}
        if leaf not in fields:
            raise ConfigError(f"unknown config path {dotted!r} (at {leaf!r})")
        ftype = _resolve_type(type(obj), fields[leaf])
        setattr(obj, leaf, _coerce(raw, ftype, dotted))

    # ---- CLI ------------------------------------------------------------------

    @classmethod
    def parse_args(cls, argv: Sequence[str] | None = None) -> "Config":
        """Parse ``--flag value`` / ``--flag=value`` argv into a config.

        Special flags: ``--config FILE`` loads a JSON file first (CLI flags
        then override it); ``--help`` prints generated usage and exits.
        """
        argv = list(sys.argv[1:] if argv is None else argv)
        if "--help" in argv or "-h" in argv:
            print(cls.usage())
            sys.exit(0)

        pairs: list[tuple[str, str]] = []
        i = 0
        cfg_file = None
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("--"):
                raise ConfigError(f"unexpected argument {tok!r} (flags are --name value)")
            name = tok[2:]
            if "=" in name:
                name, value = name.split("=", 1)
            else:
                if i + 1 >= len(argv):
                    raise ConfigError(f"flag --{name} is missing a value")
                value = argv[i + 1]
                i += 1
            if name == "config":
                cfg_file = value
            else:
                pairs.append((name, value))
            i += 1

        cfg = cls.from_file(cfg_file) if cfg_file else cls()
        for name, value in pairs:
            cfg.override(name, value)
        return cfg

    @classmethod
    def usage(cls, prefix: str = "") -> str:
        lines = [] if prefix else [f"{cls.__name__} flags:"]
        for f in dataclasses.fields(cls):
            ftype = _resolve_type(cls, f)
            dotted = f"{prefix}{f.name}"
            if isinstance(ftype, type) and issubclass(ftype, Config):
                lines.append(ftype.usage(prefix=f"{dotted}."))
            else:
                default = (
                    f.default
                    if f.default is not dataclasses.MISSING
                    else (f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
                )
                help_txt = f.metadata.get("help", "") if f.metadata else ""
                lines.append(f"  --{dotted} ({_type_name(ftype)}, default={default!r})  {help_txt}")
        return "\n".join(lines)


def parse_cli(cls: type, argv: Sequence[str] | None = None):
    return cls.parse_args(argv)


# ---- internals ----------------------------------------------------------------


def _resolve_type(cls: type, f: dataclasses.Field):
    hints = typing.get_type_hints(cls)
    return hints.get(f.name, f.type)


def _type_name(t) -> str:
    return getattr(t, "__name__", str(t))


_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _coerce(raw: Any, ftype, dotted: str):
    import types

    if not isinstance(raw, str):
        return raw
    origin = typing.get_origin(ftype)
    if origin is types.UnionType:  # PEP 604 `T | None`
        origin = typing.Union
    if origin in (list, tuple, typing.Union):
        args = typing.get_args(ftype)
        if origin is typing.Union:  # Optional[T] / T | None
            non_none = [a for a in args if a is not type(None)]
            if raw.lower() in ("none", "null"):
                return None
            return _coerce(raw, non_none[0], dotted) if non_none else raw
        elem = args[0] if args else str
        items = [s for s in raw.split(",") if s != ""]
        seq = [_coerce(s, elem, dotted) for s in items]
        return tuple(seq) if origin is tuple else seq
    if ftype is bool:
        low = raw.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ConfigError(f"--{dotted}: cannot parse {raw!r} as bool")
    if ftype in (int, float, str):
        try:
            if ftype is int:
                try:
                    return int(raw)  # plain decimal, incl. zero-padded "08"
                except ValueError:
                    return int(raw, 0)  # hex/octal/binary (0x3000 memory sizes)
            return ftype(raw)
        except ValueError as e:
            raise ConfigError(f"--{dotted}: {e}") from e
    return raw
