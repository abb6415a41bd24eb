"""Dataclass ⇄ dict/YAML serialization with camelCase wire format.

The reference's public contract is CRD YAML (SURVEY.md §1 L6,
``config/crd/bases/*.yaml``); ours is the same shape of contract — YAML
manifests in camelCase — backed by plain Python dataclasses instead of Go
structs + codegen (inventory #26's 15k generated lines collapse into this one
reflective module).
"""

from __future__ import annotations

import dataclasses
import enum
import re
import typing
from typing import Any, Type, TypeVar, get_args, get_origin

T = TypeVar("T")

_CAMEL_RE = re.compile(r"_([a-z0-9])")
_SNAKE_RE = re.compile(r"(?<!^)(?=[A-Z])")


def to_camel(s: str) -> str:
    return _CAMEL_RE.sub(lambda m: m.group(1).upper(), s)


def to_snake(s: str) -> str:
    return _SNAKE_RE.sub("_", s).lower()


def to_dict(obj: Any, *, drop_default: bool = True) -> Any:
    """Serialize a dataclass tree to plain dicts (camelCase keys).

    Fields equal to their default are dropped (keeps manifests/diffs small),
    except fields named in the class's ``__serde_keep__`` tuple.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        keep = getattr(obj, "__serde_keep__", ())
        skip = getattr(obj, "__serde_skip__", ())
        out = {}
        for f in dataclasses.fields(obj):
            if f.name in skip:
                continue   # derived/in-memory-only fields never serialize
            v = getattr(obj, f.name)
            if drop_default and f.name not in keep:
                if f.default is not dataclasses.MISSING and v == f.default:
                    continue
                if f.default_factory is not dataclasses.MISSING and v == f.default_factory():  # type: ignore[misc]
                    continue
            out[to_camel(f.name)] = to_dict(v, drop_default=drop_default)
        return out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: to_dict(v, drop_default=drop_default) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v, drop_default=drop_default) for v in obj]
    return obj


def from_dict(cls: Type[T], data: Any, *, lenient: bool = False) -> T:
    """Deserialize camelCase dicts into dataclass ``cls``.

    Strict mode (default) rejects unknown keys — admission-style schema
    checking, reference analog: CEL validation on CRDs
    (``api/workloads/v1alpha2/*_types.go`` kubebuilder markers). A typo in
    a user manifest must be an error, never a silent no-op.

    ``lenient=True`` drops unknown keys (logged once per key) — for data
    read back from DURABLE storage (state-file snapshots, stored
    ControllerRevisions), which may have been written by a newer release
    (schema-evolution Rule 3, docs/architecture.md §5)."""
    return _build(cls, data, path="$", lenient=lenient)


_warned_unknown: set = set()


def _build(tp: Any, data: Any, path: str, lenient: bool = False) -> Any:
    origin = get_origin(tp)
    if tp is Any:
        return data
    if origin is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if data is None:
            return None
        if len(args) == 1:
            return _build(args[0], data, path, lenient)
        # Multi-arm unions (IntOrString): first arm that accepts the data.
        last_err: Exception = TypeError(f"{path}: no union arm matched")
        for arm in args:
            try:
                return _build(arm, data, path, lenient)
            except (TypeError, ValueError, KeyError) as e:
                last_err = e
        raise last_err
    if origin in (list, tuple):
        if not isinstance(data, list):
            raise TypeError(f"{path}: expected list, got {type(data).__name__}")
        (elem,) = get_args(tp) or (Any,)
        return [_build(elem, v, f"{path}[{i}]", lenient) for i, v in enumerate(data)]
    if origin is dict:
        if not isinstance(data, dict):
            raise TypeError(f"{path}: expected object, got {type(data).__name__}")
        kt, vt = get_args(tp) or (str, Any)
        return {k: _build(vt, v, f"{path}.{k}", lenient) for k, v in data.items()}
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(data)
    if dataclasses.is_dataclass(tp):
        if data is None:
            data = {}
        if not isinstance(data, dict):
            raise TypeError(f"{path}: expected object for {tp.__name__}, got {type(data).__name__}")
        fields = {f.name: f for f in dataclasses.fields(tp)}
        hints = typing.get_type_hints(tp)
        kwargs = {}
        for k, v in data.items():
            name = to_snake(k)
            if name not in fields:
                if lenient:
                    marker = (tp.__name__, k)
                    if marker not in _warned_unknown:
                        _warned_unknown.add(marker)
                        import logging
                        logging.getLogger("rbg_tpu_torch.serde").warning(
                            "dropping unknown field %r for %s (written by a "
                            "newer release?)", k, tp.__name__)
                    continue
                raise KeyError(f"{path}: unknown field {k!r} for {tp.__name__}")
            kwargs[name] = _build(hints[fields[name].name], v, f"{path}.{k}", lenient)
        return tp(**kwargs)
    if tp in (int, float, str, bool):
        if tp is float and isinstance(data, int):
            return float(data)
        if not isinstance(data, tp):
            raise TypeError(f"{path}: expected {tp.__name__}, got {type(data).__name__}")
        return data
    return data


def to_yaml(obj: Any) -> str:
    import yaml

    return yaml.safe_dump(to_dict(obj), sort_keys=False)


def load_yaml_docs(text: str):
    import yaml

    return [d for d in yaml.safe_load_all(text) if d]
