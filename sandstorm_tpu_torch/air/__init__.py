from .expr import (
    Expr, X, Constant, Trace, Challenge, Hint, Pow, Inv,
    trace_arguments, evaluate_lde, evaluate_int, walk,
)

__all__ = [
    "Expr", "X", "Constant", "Trace", "Challenge", "Hint", "Pow", "Inv",
    "trace_arguments", "evaluate_lde", "evaluate_int", "walk",
]
