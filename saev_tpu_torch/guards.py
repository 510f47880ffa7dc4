"""Runtime shape and value guards at public API boundaries (the part of
saev_tpu/guards.py that the port uses: `GuardError`, `check`, `positive`,
`fraction`; the jaxtyping decorator `typed` has no counterpart here).

`check` raises `GuardError` with the offending dimension named, so a
malformed input fails with a named error instead of a cryptic framework one.
"""


class GuardError(ValueError):
    """A public-API argument had the wrong shape/dtype; message names the
    argument and the expected vs actual dimension."""


def check(name: str, x, *, ndim: int | None = None, last_dim: int | None = None,
          axis0: int | None = None, what: str = "") -> None:
    """Assert basic shape facts about an array-like, raising GuardError.

    Works on numpy arrays and torch tensors.
    """
    shape = getattr(x, "shape", None)
    if shape is None:
        raise GuardError(f"{name}: expected an array, got {type(x).__name__}")
    if ndim is not None and len(shape) != ndim:
        raise GuardError(
            f"{name}: expected {ndim} dimensions{_ctx(what)}, got shape {tuple(shape)}"
        )
    if last_dim is not None and (len(shape) == 0 or shape[-1] != last_dim):
        raise GuardError(
            f"{name}: expected trailing dimension {last_dim}{_ctx(what)}, "
            f"got shape {tuple(shape)}"
        )
    if axis0 is not None and (len(shape) == 0 or shape[0] != axis0):
        raise GuardError(
            f"{name}: expected leading dimension {axis0}{_ctx(what)}, "
            f"got shape {tuple(shape)}"
        )


def _ctx(what: str) -> str:
    return f" ({what})" if what else ""


def positive(name: str, value, *, what: str = "") -> None:
    """Assert a config scalar is a positive integer, raising GuardError."""
    if not isinstance(value, int) or isinstance(value, bool) or value < 1:
        raise GuardError(
            f"{name}: expected a positive integer{_ctx(what)}, got {value!r}"
        )


def fraction(name: str, value, *, what: str = "") -> None:
    """Assert a config scalar lies in [0, 1], raising GuardError."""
    if isinstance(value, bool):
        # float(True) == 1.0 would pass the range check; match positive().
        ok = False
    else:
        try:
            ok = 0.0 <= float(value) <= 1.0
        except (TypeError, ValueError):
            ok = False
    if not ok:
        raise GuardError(f"{name}: expected a value in [0, 1]{_ctx(what)}, got {value!r}")
