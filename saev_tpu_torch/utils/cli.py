"""Typed-dataclass CLI engine (a copy of saev_tpu/utils/cli.py).

The reference drives every entry point with tyro (reference launch.py:11-16,
framework/train.py:707): frozen-dataclass configs become dotted CLI flags, and
union-typed fields become subcommand selectors like `sae.activation:relu` or
`data:img-folder` (docs/src/users/guide.md:41, :93-95). tyro is not available in
this environment, so this module implements the same surface on argparse:

- every leaf field of a (nested) dataclass becomes `--dotted.path.with-dashes`
- union-of-dataclasses fields are selected with a bare `path.to.field:choice`
  token (choice = kebab-case class name), then that branch's fields are exposed
- scalars: int/float/str/bool/Path/Literal/tuple/list, plus `T | None`
- an optional dataclass field (`Config | None = None`) stays None unless
  `path.to.field:choice` selects its dataclass
- `--help` prints all flags with the field docstrings' first lines where cheap

Public API: `parse(cls, args) -> instance`, `run(fns, args)` for subcommand
dispatch (launch.py).
"""

import dataclasses
import enum
import pathlib
import sys
import types
import typing as tp


def _kebab(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0 and (not name[i - 1].isupper()):
            out.append("-")
        out.append(ch.lower())
    return "".join(out).replace("_", "-")


def _is_dataclass_type(t: tp.Any) -> bool:
    return isinstance(t, type) and dataclasses.is_dataclass(t)


def _union_members(t: tp.Any) -> tuple | None:
    origin = tp.get_origin(t)
    if origin is tp.Union or origin is types.UnionType:
        return tp.get_args(t)
    return None


def _dataclass_union_members(t: tp.Any) -> list[type] | None:
    """If `t` is a union made only of dataclasses (e.g. activation/dataset configs),
    return the member list; else None."""
    members = _union_members(t)
    if members is None:
        return None
    members = [m for m in members if m is not type(None)]
    if members and all(_is_dataclass_type(m) for m in members):
        return members
    return None


class CliError(SystemExit):
    def __init__(self, msg: str):
        print(f"error: {msg}", file=sys.stderr)
        super().__init__(2)


def _parse_scalar(t: tp.Any, raw: str, flag: str) -> tp.Any:
    members = _union_members(t)
    if members is not None:
        # Optional scalar: try each non-None member in order.
        errs = []
        for m in members:
            if m is type(None):
                if raw.lower() in ("none", "null"):
                    return None
                continue
            try:
                return _parse_scalar(m, raw, flag)
            except Exception as e:  # noqa: BLE001
                errs.append(str(e))
        raise CliError(f"{flag}: could not parse {raw!r} as {t} ({'; '.join(errs)})")

    if t is bool:
        low = raw.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise CliError(f"{flag}: expected a boolean, got {raw!r}")
    if t is int:
        return int(raw)
    if t is float:
        return float(raw)
    if t is str:
        return raw
    if t is pathlib.Path or t is pathlib.PurePath:
        return pathlib.Path(raw)
    if isinstance(t, type) and issubclass(t, enum.Enum):
        for member in t:
            if raw in (member.name, member.name.lower(), str(member.value), _kebab(member.name)):
                return member
        raise CliError(
            f"{flag}: expected one of {[m.name.lower() for m in t]}, got {raw!r}"
        )
    origin = tp.get_origin(t)
    if origin is tp.Literal:
        choices = tp.get_args(t)
        for c in choices:
            if raw == str(c):
                return c
        raise CliError(f"{flag}: expected one of {list(choices)}, got {raw!r}")
    if origin in (tuple, list):
        args = tp.get_args(t)
        elem = args[0] if args else str
        items = [s for s in raw.split(",") if s != ""]
        vals = [_parse_scalar(elem, s, flag) for s in items]
        return tuple(vals) if origin is tuple else vals
    raise CliError(f"{flag}: unsupported field type {t}")


@dataclasses.dataclass
class _Leaf:
    path: tuple[str, ...]
    type: tp.Any
    help: str = ""

    @property
    def flag(self) -> str:
        return "--" + ".".join(_kebab(p) for p in self.path)


def _collect_leaves(
    cls: type, prefix: tuple[str, ...], selections: dict[tuple[str, ...], type]
) -> list[_Leaf]:
    """Walk a dataclass, descending into nested dataclasses and selected union
    branches, producing the flat flag list."""
    leaves: list[_Leaf] = []
    hints = tp.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        t = hints.get(f.name, f.type)
        path = prefix + (f.name,)
        union = _dataclass_union_members(t)
        if union is not None:
            chosen = selections.get(path)
            if chosen is None:
                # Default branch: the default value's class.
                if f.default is not dataclasses.MISSING:
                    chosen = type(f.default)
                elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                    chosen = type(f.default_factory())  # type: ignore[misc]
                else:
                    chosen = union[0]
                selections[path] = chosen
            if chosen is type(None):
                # An optional config left at its default None: no flags
                # until `path:choice` selects one of its dataclasses.
                continue
            leaves.extend(_collect_leaves(chosen, path, selections))
        elif _is_dataclass_type(t):
            leaves.extend(_collect_leaves(t, path, selections))
        else:
            leaves.append(_Leaf(path=path, type=t))
    return leaves


def _build(
    cls: type,
    prefix: tuple[str, ...],
    selections: dict[tuple[str, ...], type],
    overrides: dict[tuple[str, ...], tp.Any],
) -> tp.Any:
    hints = tp.get_type_hints(cls)
    kwargs: dict[str, tp.Any] = {}
    for f in dataclasses.fields(cls):
        t = hints.get(f.name, f.type)
        path = prefix + (f.name,)
        union = _dataclass_union_members(t)
        if union is not None:
            chosen = selections[path]
            touched = any(k[: len(path)] == path for k in overrides)
            if (
                not touched
                and f.default is not dataclasses.MISSING
                and type(f.default) is chosen
            ):
                # Untouched branch matching the default keeps the default instance.
                kwargs[f.name] = f.default
            else:
                kwargs[f.name] = _build(chosen, path, selections, overrides)
        elif _is_dataclass_type(t):
            kwargs[f.name] = _build(t, path, selections, overrides)
        elif path in overrides:
            kwargs[f.name] = overrides[path]
        elif f.default is not dataclasses.MISSING:
            kwargs[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            kwargs[f.name] = f.default_factory()  # type: ignore[misc]
        else:
            raise CliError(f"missing required flag --{'.'.join(map(_kebab, path))}")
    return cls(**kwargs)


def _union_choices(cls: type) -> dict[tuple[str, ...], dict[str, type]]:
    """All union-typed fields reachable from cls (one level of recursion per
    selected branch happens lazily in parse)."""
    out: dict[tuple[str, ...], dict[str, type]] = {}

    def walk(c: type, prefix: tuple[str, ...], seen: frozenset):
        if c in seen:
            return
        hints = tp.get_type_hints(c)
        for f in dataclasses.fields(c):
            t = hints.get(f.name, f.type)
            path = prefix + (f.name,)
            union = _dataclass_union_members(t)
            if union is not None:
                out[path] = {_kebab(m.__name__): m for m in union}
                for m in union:
                    walk(m, path, seen | {c})
            elif _is_dataclass_type(t):
                walk(t, path, seen | {c})

    walk(cls, (), frozenset())
    return out


def parse(cls: type, args: list[str], *, prog: str = "") -> tp.Any:
    """Parse CLI args into an instance of dataclass `cls`.

    Grammar (tyro-compatible subset):
        path.to.field:choice     select a union branch
        --path.to.field VALUE    set a leaf field
        --path.to.field=VALUE    same
        --flag / --no-flag       booleans
        --help                   print flags and exit
    """
    choices = _union_choices(cls)
    selections: dict[tuple[str, ...], type] = {}
    rest: list[str] = []

    by_kebab = {
        ".".join(_kebab(p) for p in path): (path, opts)
        for path, opts in choices.items()
    }

    for tok in args:
        # A bare `path.to.field:choice` token selects a union branch — but only
        # when the name matches a known union field, so flag *values* containing
        # ":" (e.g. "hf-hub:org/model") pass through untouched.
        if not tok.startswith("--") and ":" in tok and tok.partition(":")[0] in by_kebab:
            name, _, choice = tok.partition(":")
            path, opts = by_kebab[name]
            if choice not in opts:
                raise CliError(
                    f"{name}: unknown choice {choice!r}; options: {sorted(opts)}"
                )
            selections[path] = opts[choice]
        else:
            rest.append(tok)

    leaves = _collect_leaves(cls, (), selections)
    flag_map = {leaf.flag: leaf for leaf in leaves}

    if "--help" in rest or "-h" in rest:
        print(f"usage: {prog or cls.__name__} [field:choice ...] [--flag value ...]\n")
        if by_kebab:
            print("subcommand fields:")
            for name, (_, opts) in sorted(by_kebab.items()):
                print(f"  {name}:{{{','.join(sorted(opts))}}}")
            print()
        print("flags:")
        for leaf in leaves:
            tname = getattr(leaf.type, "__name__", str(leaf.type))
            print(f"  {leaf.flag}  ({tname})")
        raise SystemExit(0)

    overrides: dict[tuple[str, ...], tp.Any] = {}
    i = 0
    while i < len(rest):
        tok = rest[i]
        if not tok.startswith("--"):
            raise CliError(f"unexpected argument {tok!r}")
        if "=" in tok:
            flag, _, raw = tok.partition("=")
            i += 1
        else:
            flag = tok
            # --no-foo boolean negation
            neg = flag.replace("--no-", "--", 1)
            if flag.startswith("--no-") and neg in flag_map and flag_map[neg].type is bool:
                overrides[flag_map[neg].path] = False
                i += 1
                continue
            if flag in flag_map and flag_map[flag].type is bool and (
                i + 1 >= len(rest) or rest[i + 1].startswith("--")
            ):
                overrides[flag_map[flag].path] = True
                i += 1
                continue
            if i + 1 >= len(rest):
                raise CliError(f"{flag}: missing value")
            raw = rest[i + 1]
            i += 2
        if flag not in flag_map:
            raise CliError(f"unknown flag {flag}; see --help")
        leaf = flag_map[flag]
        overrides[leaf.path] = _parse_scalar(leaf.type, raw, flag)

    return _build(cls, (), selections, overrides)


def run(fns: dict[str, tp.Callable], argv: list[str] | None = None):
    """Dispatch `prog subcommand [args...]` to `fns[subcommand]`, parsing the
    function's dataclass-typed parameters from the remaining args (launch.py).

    Each fn must have a first parameter annotated with a dataclass config type;
    extra optional parameters (e.g. `sweep: Path | None`) map to top-level flags.
    """
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: launch.py {" + ",".join(sorted(fns)) + "} [options]")
        raise SystemExit(0 if argv else 2)
    name, *args = argv
    if name not in fns:
        raise CliError(f"unknown command {name!r}; options: {sorted(fns)}")
    fn = fns[name]

    hints = tp.get_type_hints(fn)
    sig_params = list(tp.get_type_hints(fn).keys())
    import inspect

    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    assert params, f"{name} takes no parameters"
    cfg_cls = hints[params[0].name]
    assert _is_dataclass_type(cfg_cls), f"{name}'s first parameter must be a dataclass"

    # Split out flags belonging to the extra (scalar) parameters.
    extra: dict[str, tp.Any] = {}
    remaining: list[str] = []
    extra_params = {p.name: hints.get(p.name) for p in params[1:]}
    i = 0
    while i < len(args):
        tok = args[i]
        matched = False
        for pname, ptype in extra_params.items():
            flag = "--" + _kebab(pname)
            if tok == flag or tok.startswith(flag + "="):
                if "=" in tok:
                    raw = tok.partition("=")[2]
                    i += 1
                else:
                    if i + 1 >= len(args):
                        raise CliError(f"{flag}: missing value")
                    raw = args[i + 1]
                    i += 2
                extra[pname] = _parse_scalar(ptype, raw, flag)
                matched = True
                break
        if not matched:
            remaining.append(tok)
            i += 1

    cfg = parse(cfg_cls, remaining, prog=f"launch.py {name}")
    return fn(cfg, **extra)
