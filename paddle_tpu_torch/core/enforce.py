"""Runtime checks — successor of ``paddle/platform/enforce.h`` (PADDLE_ENFORCE)
and ``paddle/utils/Error.h``.  Raises a typed error carrying the layer/op stack
the way ``CustomStackTrace`` annotates failures in the reference."""

from __future__ import annotations

import contextlib


class EnforceError(RuntimeError):
    """Framework invariant violation (≅ paddle::platform::EnforceNotMet)."""


_scope_stack: list[str] = []


@contextlib.contextmanager
def error_scope(name: str):
    """Push a named scope (layer/op) for error context, like CustomStackTrace."""
    _scope_stack.append(name)
    try:
        yield
    finally:
        _scope_stack.pop()


def current_scope() -> str:
    return "/".join(_scope_stack)


def enforce(cond: bool, msg: str = "", *fmt_args) -> None:
    if not cond:
        text = msg % fmt_args if fmt_args else msg
        scope = current_scope()
        if scope:
            text = f"[{scope}] {text}"
        raise EnforceError(text or "enforce failed")


def enforce_eq(a, b, msg: str = "") -> None:
    enforce(a == b, f"{msg + ': ' if msg else ''}expected {a!r} == {b!r}")


def enforce_shape(shape, expected, msg: str = "") -> None:
    enforce(
        tuple(shape) == tuple(expected),
        f"{msg + ': ' if msg else ''}shape mismatch: got {tuple(shape)}, want {tuple(expected)}",
    )
