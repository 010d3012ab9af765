from .errors import CudfLikeError, expects, fail

__all__ = ["CudfLikeError", "expects", "fail"]
