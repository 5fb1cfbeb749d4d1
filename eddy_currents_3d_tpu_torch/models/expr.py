"""Runtime math-expression language, evaluated on the host in float64.

The PyTorch counterpart of ``eddy_currents_3d_tpu/models/expr.py``: the same
tokenizer, recursive-descent parser and host scalar evaluator (the
``_HOST_FUNCS`` table), without the jnp table.  Source and motion-velocity
expressions depend only on the time t, which the step schedule fixes on the
host, so the port evaluates them there in Python float64 and casts to the
working dtype at the scatter (as the JAX package does under x64).

Function set and semantics match the reference VM (m_fparser.f90:33-104,
158-241):

=========  =============================================================
name       meaning
=========  =============================================================
abs        absolute value
exp        e**x
lg         log10(x); returns 0 for x <= 0 (EvalErrType=3 path)
ln         natural log
sqrt       square root
sh/ch/th   sinh / cosh / tanh
cth        coth = cosh/sinh
sind/cosd  sine / cosine in DEGREES
tgd        tangent in DEGREES
sin/cos/tg sine / cosine / tangent (radians)
asin/acos  returns 0 when |x| > 1 (EvalErrType=4 path)
atg        arctangent
impls      unit step:  1 if x > 0 else 0          (cU)
impl2      sign step:  1 if x >= 0 else -1        (cU2)
pos        ramp: x if x > 0 else 0                (cPos)
int        truncate toward zero (Fortran AINT)
nint       round half away from zero (Fortran ANINT)
floor/ceil floor / ceiling
=========  =============================================================

Binary ops: ``+ - * / ^`` (and ``**`` as a synonym for ``^``); division by
zero yields 0 (the VM aborts evaluation with result 0, m_fparser.f90:180).
Power is right-associative like the reference's recursive compile.
Identifiers are case-insensitive.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as _np

__all__ = ["Expression", "compile_expression", "ExprError"]


class ExprError(ValueError):
    """Raised on a malformed expression string."""


_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>(?:\d+\.?\d*|\.\d+)(?:[eEdD][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<op>\*\*|[-+*/^()])"
    r")"
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == pos:
            rest = text[pos:].strip()
            if not rest:
                break
            raise ExprError(f"cannot tokenize {text!r} at {rest[:10]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            tokens.append(("num", m.group("num").lower().replace("d", "e")))
        elif m.lastgroup == "name":
            tokens.append(("name", m.group("name").upper()))
        else:
            op = m.group("op")
            tokens.append(("op", "^" if op == "**" else op))
    tokens.append(("end", ""))
    return tokens


# --- AST ------------------------------------------------------------------

@dataclass(frozen=True)
class _Num:
    value: float


@dataclass(frozen=True)
class _Var:
    name: str


@dataclass(frozen=True)
class _Un:
    op: str
    arg: object


@dataclass(frozen=True)
class _Bin:
    op: str
    lhs: object
    rhs: object


@dataclass(frozen=True)
class _Call:
    fn: str
    arg: object


_DEG = math.pi / 180.0


def _h_safe_div(a, b):
    return 0.0 if b == 0 else a / b


def _h_anint(x):
    return float(math.trunc(x + (0.5 if x >= 0 else -0.5)))


def _h1(np_fn):
    """Scalar host wrapper over a numpy ufunc: nan/inf on domain errors
    (math.* would raise instead)."""

    def call(x):
        with _np.errstate(all="ignore"):
            return float(np_fn(_np.float64(x)))

    return call


_HOST_FUNCS: dict[str, Callable] = {
    "ABS": lambda x: float(abs(x)),
    "EXP": _h1(_np.exp),
    "LG": lambda x: float(_np.log10(_np.float64(x))) if x > 0 else 0.0,
    "LN": _h1(_np.log),
    "SQRT": _h1(_np.sqrt),
    "SH": _h1(_np.sinh),
    "CH": _h1(_np.cosh),
    "TH": _h1(_np.tanh),
    "CTH": lambda x: _h_safe_div(math.cosh(x), math.sinh(x)),
    "SIND": lambda x: math.sin(x * _DEG),
    "COSD": lambda x: math.cos(x * _DEG),
    "TGD": lambda x: math.tan(x * _DEG),
    "SIN": math.sin,
    "COS": math.cos,
    "TG": math.tan,
    "ASIN": lambda x: math.asin(max(-1.0, min(1.0, x))) if abs(x) <= 1 else 0.0,
    "ACOS": lambda x: math.acos(max(-1.0, min(1.0, x))) if abs(x) <= 1 else 0.0,
    "IMPLS": lambda x: 1.0 if x > 0 else 0.0,
    "IMPL2": lambda x: 1.0 if x >= 0 else -1.0,
    "POS": lambda x: x if x > 0 else 0.0,
    "INT": lambda x: float(math.trunc(x)),
    "NINT": _h_anint,
    "FLOOR": lambda x: float(math.floor(x)),
    "CEIL": lambda x: float(math.ceil(x)),
    "ATG": math.atan,
}


class _Parser:
    """Recursive-descent: expr := term (('+'|'-') term)*; term := factor
    (('*'|'/') factor)*; factor := ['-'|'+'] power; power := atom ['^' factor].
    """

    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect_op(self, op: str):
        kind, val = self.next()
        if kind != "op" or val != op:
            raise ExprError(f"expected {op!r}, got {val!r}")

    def parse(self):
        node = self.expr()
        if self.peek()[0] != "end":
            raise ExprError(f"trailing input at {self.peek()[1]!r}")
        return node

    def expr(self):
        node = self.term()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            _, op = self.next()
            node = _Bin(op, node, self.term())
        return node

    def term(self):
        node = self.factor()
        while self.peek() == ("op", "*") or self.peek() == ("op", "/"):
            _, op = self.next()
            node = _Bin(op, node, self.factor())
        return node

    def factor(self):
        if self.peek() == ("op", "-"):
            self.next()
            return _Un("-", self.factor())
        if self.peek() == ("op", "+"):
            self.next()
            return self.factor()
        return self.power()

    def power(self):
        node = self.atom()
        if self.peek() == ("op", "^"):
            self.next()
            # right-associative; exponent may carry its own unary sign
            node = _Bin("^", node, self.factor())
        return node

    def atom(self):
        kind, val = self.next()
        if kind == "num":
            return _Num(float(val))
        if kind == "name":
            if self.peek() == ("op", "("):
                if val not in _HOST_FUNCS:
                    raise ExprError(f"unknown function {val!r}")
                self.next()
                arg = self.expr()
                self.expect_op(")")
                return _Call(val, arg)
            return _Var(val)
        if (kind, val) == ("op", "("):
            node = self.expr()
            self.expect_op(")")
            return node
        raise ExprError(f"unexpected token {val!r}")


def _free_vars(node, out: set[str]):
    if isinstance(node, _Var):
        out.add(node.name)
    elif isinstance(node, _Un):
        _free_vars(node.arg, out)
    elif isinstance(node, _Bin):
        _free_vars(node.lhs, out)
        _free_vars(node.rhs, out)
    elif isinstance(node, _Call):
        _free_vars(node.arg, out)


def _eval(node, env: Mapping[str, float]) -> float:
    if isinstance(node, _Num):
        return node.value
    if isinstance(node, _Var):
        try:
            return env[node.name]
        except KeyError:
            raise ExprError(f"unbound variable {node.name!r}") from None
    if isinstance(node, _Un):
        return -_eval(node.arg, env)
    if isinstance(node, _Bin):
        a = _eval(node.lhs, env)
        b = _eval(node.rhs, env)
        if node.op == "+":
            return a + b
        if node.op == "-":
            return a - b
        if node.op == "*":
            return a * b
        if node.op == "/":
            return _h_safe_div(a, b)
        with _np.errstate(all="ignore"):
            return float(_np.power(_np.float64(a), _np.float64(b)))
    if isinstance(node, _Call):
        return _HOST_FUNCS[node.fn](_eval(node.arg, env))
    raise TypeError(node)


@dataclass(frozen=True)
class Expression:
    """A compiled expression. Call with a variable environment (names are
    case-insensitive) of plain Python or numpy scalars; returns a float."""

    source: str
    root: object
    variables: frozenset[str]

    def __call__(self, env: Mapping[str, object] | None = None, **kwargs) -> float:
        merged = {k.upper(): v for k, v in (env or {}).items()}
        merged.update({k.upper(): v for k, v in kwargs.items()})
        for k in self.variables:
            v = merged.get(k)
            if v is not None and not isinstance(
                    v, (int, float, _np.integer, _np.floating)):
                raise ExprError(
                    f"variable {k!r} must be a host scalar, got {type(v).__name__}")
        return _eval(self.root, merged)


def compile_expression(text: str, variables: Sequence[str] | None = None) -> Expression:
    """Parse ``text`` once into a reusable :class:`Expression`.

    ``variables``, when given, is the allowed variable set (the reference
    passes the explicit argument-name list to ``parsef``); unknown names
    raise :class:`ExprError` at compile time instead of evaluation time.
    """
    root = _Parser(_tokenize(text)).parse()
    free: set[str] = set()
    _free_vars(root, free)
    if variables is not None:
        allowed = {v.strip().upper() for v in variables}
        unknown = free - allowed
        if unknown:
            raise ExprError(f"unknown variable(s) {sorted(unknown)} in {text!r}")
    return Expression(source=text, root=root, variables=frozenset(free))
