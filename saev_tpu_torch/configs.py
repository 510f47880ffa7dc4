"""Typed-dataclass config + sweep engine (a copy of saev_tpu/configs.py).

Sweeps are Python files exporting `make_cfgs() -> list[dict]`; each dict may hold
list values that are expanded via cartesian product. CLI overrides beat sweep values,
and seeds auto-increment per expanded config. Semantics mirror the reference's
`src/saev/configs.py:17-311` (its test_configs.py defines the contract).
"""

import dataclasses
import enum
import itertools
import logging
import pathlib
import types
import typing as tp
from collections.abc import Iterator

T = tp.TypeVar("T")

logger = logging.getLogger(__name__)


def load_sweep(sweep_fpath: pathlib.Path) -> list[dict]:
    """Execute a sweep file's `make_cfgs()` and return its config dicts.

    A sweep file is plain Python defining `make_cfgs() -> list[dict]` (the
    protocol the reference pins in `src/saev/configs.py:16-39`; our sweep
    files are interchangeable with its — see the live equivalence test).
    Anything that goes wrong — unreadable file, syntax error, missing or
    raising `make_cfgs`, a non-list return — degrades to `[]` with a logged
    warning so one broken sweep file never kills a launcher.
    """
    def run() -> object:
        scope: dict[str, object] = {}
        exec(compile(sweep_fpath.read_text(), str(sweep_fpath), "exec"), scope)
        return scope["make_cfgs"]()

    try:
        dcts = run()
    except Exception as err:
        logger.warning("sweep file %s unusable (%s); ignoring it", sweep_fpath, err)
        return []
    if not isinstance(dcts, list):
        logger.warning(
            "sweep file %s: make_cfgs() must return a list, not %s; ignoring it",
            sweep_fpath,
            type(dcts).__name__,
        )
        return []
    return dcts


def expand(config: dict[str, object]) -> Iterator[dict[str, object]]:
    """Expand a nested dict whose list values are axes into the full grid.

    Implemented as flatten → product → unflatten: every leaf path of the
    nested dict becomes an axis (a list value contributes its elements, a
    scalar contributes a single option), and one `itertools.product` over the
    axes — later leaves varying fastest — reproduces the reference engine's
    enumeration order exactly (pinned by the live-equivalence test).
    """
    axes: list[tuple[tuple[str, ...], list]] = []
    _flatten_axes(config, (), axes)
    for combo in itertools.product(*(options for _, options in axes)):
        grid_point: dict[str, object] = {}
        for (path, _), value in zip(axes, combo):
            node = grid_point
            for key in path[:-1]:
                node = node.setdefault(key, {})  # type: ignore[assignment]
            node[path[-1]] = value
        yield grid_point


def _flatten_axes(
    node: dict[str, object],
    path: tuple[str, ...],
    axes: list[tuple[tuple[str, ...], list]],
) -> None:
    """Depth-first leaf walk; each leaf contributes one product axis."""
    for key, value in node.items():
        if isinstance(value, dict) and value:
            _flatten_axes(value, path + (key,), axes)
        elif isinstance(value, list):
            axes.append((path + (key,), value))
        else:
            # Scalars (and empty dicts) are degenerate one-option axes.
            axes.append((path + (key,), [value]))


def load_cfgs(
    override: T, *, default: T, sweep_dcts: list[dict]
) -> tuple[list[T], list[str]]:
    """Build configs by merging CLI overrides > sweep values > defaults.

    Args:
        override: Command-line overridden config instance.
        default: The default config instance.
        sweep_dcts: Expanded sweep dicts (list values already expanded by caller or not;
            caller typically runs `expand` per dict before this).

    Returns:
        (configs, errors).
    """
    assert dataclasses.is_dataclass(override) and not isinstance(override, type)
    assert dataclasses.is_dataclass(default) and not isinstance(default, type)

    if not sweep_dcts:
        return [override], []

    overridden_fields = get_non_default_values(override, default)

    cfgs: list[T] = []
    errs: list[str] = []
    # Every expanded config — even ones that fail or collapse to the bare
    # override — advances `d`, so seeds stay distinct and stable regardless
    # of which grid points error out.
    d = 0

    for sweep_dct in sweep_dcts:
        filtered_dct = _filter_overridden_fields(sweep_dct, overridden_fields)

        if not filtered_dct:
            cfgs.append(override)
            d += 1
            continue

        try:
            updates = _recursive_dataclass_update(override, filtered_dct, override, d)
            if hasattr(override, "seed") and "seed" not in updates:
                updates["seed"] = getattr(override, "seed", 0) + d
            cfgs.append(dataclasses.replace(override, **updates))
            d += 1
        except Exception as err:
            errs.append(str(err))
            d += 1

    return cfgs, errs


def _filter_overridden_fields(
    dct: dict[str, object], overridden: dict[str, object]
) -> dict[str, object]:
    """Remove fields from `dct` that were explicitly overridden on the CLI."""
    result: dict[str, object] = {}
    for key, value in dct.items():
        if key not in overridden:
            result[key] = value
            continue

        if isinstance(value, dict):
            overridden_value = overridden.get(key)

            if isinstance(overridden_value, dict):
                filtered = _filter_overridden_fields(value, overridden_value)
                if filtered:
                    result[key] = filtered
                continue

            if dataclasses.is_dataclass(overridden_value) and not isinstance(
                overridden_value, type
            ):
                try:
                    default_value = type(overridden_value)()
                except TypeError:
                    # No zero-arg constructor means no baseline to diff the
                    # override against — the safe reading is "the CLI set the
                    # whole subtree", so the sweep loses this key entirely.
                    continue
                nested_overrides = get_non_default_values(
                    overridden_value, default_value
                )
                filtered = _filter_overridden_fields(value, nested_overrides)
                if filtered:
                    result[key] = filtered
                continue

            # Scalar override wins over a dict sweep value.
            continue
        # Non-dict value on an overridden field: drop it (override wins).
    return result


def _convert_value(value: object, field_type: object, *, strict: bool = True) -> object:
    """Coerce a sweep/JSON value to the declared field type.

    One coercion table shared by the sweep-update path (strict: a scalar that
    doesn't match its declared type is an error the launcher reports) and the
    `dict_to_dataclass` path (lenient: values pass through untyped, matching
    the reference's loader at `src/saev/configs.py:214-260`).
    """
    origin = tp.get_origin(field_type)
    args = tp.get_args(field_type)

    if (
        origin in (tp.Union, types.UnionType)
        and isinstance(value, dict)
        and (variant := _union_variant(args, value)) is not None
    ):
        return dict_to_dataclass(value, variant)
    if origin is tuple and args:
        return tuple(value) if isinstance(value, list) else value
    if origin is list and args and dataclasses.is_dataclass(args[0]):
        return [dict_to_dataclass(item, args[0]) for item in value]
    if dataclasses.is_dataclass(field_type):
        return dict_to_dataclass(value, field_type)
    path_like = field_type is pathlib.Path or (
        origin in (tp.Union, types.UnionType) and pathlib.Path in args
    )
    if path_like:
        return pathlib.Path(value) if value is not None else value
    if (
        isinstance(field_type, type)
        and issubclass(field_type, enum.Enum)
        and not isinstance(value, field_type)
    ):
        # Sweep files carry enums as their VALUE strings (e.g. "max" for
        # PatchAgg.MAX), falling back to the member name.
        try:
            return field_type(value)
        except ValueError:
            return field_type[str(value).upper()]
    if strict and isinstance(field_type, type) and not isinstance(value, field_type):
        raise TypeError(f"Expected {field_type.__name__}, got {type(value).__name__}")
    return value


def _union_variant(args: tuple, value: dict) -> type | None:
    """The dataclass member of a union whose `key` literal default matches
    value["key"] — how sweep dicts pick an activation/sparsity/aux/head
    variant (e.g. {"key": "relu", ...} selects Relu inside ActivationConfig).
    None when the dict carries no key or nothing matches (the caller then
    merges into the current variant, the pre-existing behavior)."""
    key = value.get("key")
    if key is None:
        return None
    for arg in args:
        if not dataclasses.is_dataclass(arg):
            continue
        field = arg.__dataclass_fields__.get("key")
        if field is not None and field.default == key:
            return arg
    return None


def _resolve_field_type(cls: type, name: str) -> object:
    """Resolve a dataclass field's type, handling string annotations."""
    field_type = cls.__dataclass_fields__[name].type
    if isinstance(field_type, str):
        hints = tp.get_type_hints(cls)
        field_type = hints.get(name, field_type)
    return field_type


def _recursive_dataclass_update(obj, updates: dict[str, object], base_cfg, d: int):
    """Recursively compute `dataclasses.replace` kwargs for nested dataclasses."""
    if not dataclasses.is_dataclass(obj):
        return updates

    result: dict[str, object] = {}
    for key, value in updates.items():
        if not hasattr(obj, key):
            result[key] = value
            continue

        attr = getattr(obj, key)
        field_type = _resolve_field_type(type(obj), key)

        if dataclasses.is_dataclass(attr) and isinstance(value, dict):
            origin = tp.get_origin(field_type)
            if origin in (tp.Union, types.UnionType):
                variant = _union_variant(tp.get_args(field_type), value)
                if variant is not None and type(attr) is not variant:
                    # The sweep switches the union variant: build it fresh
                    # from the dict instead of merging into the old variant.
                    result[key] = dict_to_dataclass(value, variant)
                    continue
            nested_updates = _recursive_dataclass_update(attr, value, base_cfg, d)
            if hasattr(attr, "seed") and "seed" not in nested_updates:
                base_seed = getattr(base_cfg, "seed", 0) if base_cfg else 0
                nested_updates["seed"] = getattr(attr, "seed", 0) + base_seed + d
            result[key] = dataclasses.replace(attr, **nested_updates)
        else:
            result[key] = _convert_value(value, field_type)

    return result


def dict_to_dataclass(data: dict, cls: type[T]) -> T:
    """Instantiate `cls` from a plain dict, coercing nested fields lazily.

    Unknown keys are ignored; present keys run through the shared coercion
    table in lenient mode (no scalar type enforcement — JSON round-trips may
    legitimately hand an int where a float is declared).
    """
    if not dataclasses.is_dataclass(cls):
        return data  # type: ignore[return-value]

    kwargs = {
        f.name: _convert_value(
            data[f.name], _resolve_field_type(cls, f.name), strict=False
        )
        for f in dataclasses.fields(cls)
        if f.name in data
    }
    return cls(**kwargs)


def get_non_default_values(obj: T, default_obj: T) -> dict:
    """Recursively find fields that differ from defaults."""
    assert dataclasses.is_dataclass(obj) and not isinstance(obj, type)
    assert dataclasses.is_dataclass(default_obj) and not isinstance(default_obj, type)

    diff: dict[str, object] = {}
    for field in dataclasses.fields(obj):
        obj_value = getattr(obj, field.name)
        default_value = getattr(default_obj, field.name)

        if obj_value == default_value:
            continue

        if (
            dataclasses.is_dataclass(obj_value)
            and dataclasses.is_dataclass(default_value)
            and type(obj_value) is type(default_value)
        ):
            nested_diff = get_non_default_values(obj_value, default_value)
            if nested_diff:
                diff[field.name] = nested_diff
        else:
            diff[field.name] = obj_value

    return diff
