"""Precondition helpers, the ``CUDF_EXPECTS``/``CUDF_FAIL`` analogs.

Host-side validation raises ``CudfLikeError`` before any device work is
queued, so failures are synchronous and carry a message.
"""

from __future__ import annotations


class CudfLikeError(RuntimeError):
    """Logic/precondition error, the ``cudf::logic_error`` analog."""


def expects(condition: bool, message: str) -> None:
    """``CUDF_EXPECTS`` analog: raise if a precondition does not hold."""
    if not condition:
        raise CudfLikeError(message)


def null_check(value, message: str) -> None:
    """``JNI_NULL_CHECK`` analog for host-API arguments."""
    if value is None:
        raise ValueError(message)


def fail(message: str) -> "NoReturn":  # noqa: F821
    """``CUDF_FAIL`` analog: unconditional failure."""
    raise CudfLikeError(message)
