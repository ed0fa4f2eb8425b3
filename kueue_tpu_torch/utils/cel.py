"""A CEL-subset compiler for DRA device selectors.

A copy of ``kueue_tpu/utils/cel.py`` (pure Python), with the same error
classes and messages.

Reference: pkg/dra/claims.go compiles DeviceSelector CEL expressions with
the upstream k8s.io/dynamic-resource-allocation/cel compiler (claims
carry expressions like ``device.driver == "tpu.example.com" &&
device.attributes["example.com/memory"] >= 16``) and evaluates them per
device. This module implements the expression subset those selectors
use — no host ``eval``, a hand-written tokenizer + recursive-descent
parser compiled to closures, with a bounded compilation cache
(claims.go:41-43 celCache analog).

Grammar (CEL operator precedence):
  or:      and ("||" and)*
  and:     not ("&&" not)*
  not:     "!" not | cmp
  cmp:     add (("=="|"!="|"<"|"<="|">"|">="|"in") add)?
  add:     unary (("+"|"-") unary)*
  unary:   "-" unary | postfix
  postfix: primary ("." ident | "." ident "(" args ")" | "[" or "]")*
  primary: literal | ident | "(" or ")" | list

Supported calls: startsWith, endsWith, contains, matches (RE2-style via
``re``), size. Maps support membership (``"k" in device.attributes``)
and indexing; missing keys raise ``CelEvalError`` exactly like CEL's
no-such-key runtime error, which device matching treats as "no match"
(the upstream evaluator's error-per-device behavior).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Callable

__all__ = ["CelCompileError", "CelEvalError", "compile_cel", "evaluate",
           "evaluate_predicate"]


class CelCompileError(ValueError):
    """Syntax / structure error at compile time (claims.go:235
    validateCELSelectors surfaces these before quota admission)."""


class CelEvalError(RuntimeError):
    """Runtime evaluation error (missing key, type mismatch)."""


_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<float>\d+\.\d+)
    | (?P<int>\d+)
    | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op>\|\||&&|==|!=|<=|>=|[!<>().,\[\]+-])
    )""", re.VERBOSE)

_KEYWORDS = {"true": True, "false": False, "null": None}


def _tokenize(src: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None or m.end() == pos:
            rest = src[pos:].strip()
            if not rest:
                break
            raise CelCompileError(
                f"unexpected character {rest[0]!r} at offset {pos}")
        pos = m.end()
        for kind in ("float", "int", "string", "ident", "op"):
            tok = m.group(kind)
            if tok is not None:
                out.append((kind, tok))
                break
    out.append(("eof", ""))
    return out


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    return re.sub(r"\\(.)", lambda m: {
        "n": "\n", "t": "\t", "r": "\r"}.get(m.group(1), m.group(1)),
        body)


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, op: str) -> None:
        kind, tok = self.next()
        if kind != "op" or tok != op:
            raise CelCompileError(f"expected {op!r}, got {tok!r}")

    # -- precedence levels --

    def parse(self) -> Callable:
        e = self.or_()
        kind, tok = self.peek()
        if kind != "eof":
            raise CelCompileError(f"trailing input at {tok!r}")
        return e

    def or_(self) -> Callable:
        left = self.and_()
        while self.peek() == ("op", "||"):
            self.next()
            right = self.and_()
            left = (lambda lf, rf: lambda env:
                    _truthy(lf(env)) or _truthy(rf(env)))(left, right)
        return left

    def and_(self) -> Callable:
        left = self.not_()
        while self.peek() == ("op", "&&"):
            self.next()
            right = self.not_()
            left = (lambda lf, rf: lambda env:
                    _truthy(lf(env)) and _truthy(rf(env)))(left, right)
        return left

    def not_(self) -> Callable:
        if self.peek() == ("op", "!"):
            self.next()
            inner = self.not_()
            return lambda env, f=inner: not _truthy(f(env))
        return self.cmp()

    _CMP = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b,
            "<": lambda a, b: _ordered(a, b) and a < b,
            "<=": lambda a, b: _ordered(a, b) and a <= b,
            ">": lambda a, b: _ordered(a, b) and a > b,
            ">=": lambda a, b: _ordered(a, b) and a >= b}

    def cmp(self) -> Callable:
        left = self.add()
        kind, tok = self.peek()
        if kind == "op" and tok in self._CMP:
            self.next()
            right = self.add()
            fn = self._CMP[tok]
            return lambda env, lf=left, rf=right, f=fn: f(lf(env), rf(env))
        if kind == "ident" and tok == "in":
            self.next()
            right = self.add()

            def member(env, lf=left, rf=right):
                container = rf(env)
                if isinstance(container, (dict, list, tuple, str)):
                    try:
                        return lf(env) in container
                    except TypeError as e:
                        raise CelEvalError(str(e)) from e
                raise CelEvalError("'in' needs a list, map or string")
            return member
        return left

    def add(self) -> Callable:
        left = self.unary()
        while True:
            kind, tok = self.peek()
            if kind == "op" and tok in ("+", "-"):
                self.next()
                right = self.unary()

                def arith(env, lf=left, rf=right, op=tok):
                    a, b = lf(env), rf(env)
                    if op == "+" and isinstance(a, str) \
                            and isinstance(b, str):
                        return a + b
                    if not isinstance(a, (int, float)) \
                            or not isinstance(b, (int, float)) \
                            or isinstance(a, bool) or isinstance(b, bool):
                        raise CelEvalError(f"bad operands for {op!r}")
                    return a + b if op == "+" else a - b
                left = arith
            else:
                return left

    def unary(self) -> Callable:
        if self.peek() == ("op", "-"):
            self.next()
            inner = self.unary()

            def neg(env, f=inner):
                v = f(env)
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    raise CelEvalError("unary '-' needs a number")
                return -v
            return neg
        return self.postfix()

    _METHODS = {
        "startsWith": lambda s, a: _str(s).startswith(_str(a)),
        "endsWith": lambda s, a: _str(s).endswith(_str(a)),
        "contains": lambda s, a: _str(a) in _str(s),
        "matches": lambda s, a: _re_search(_str(s), _str(a)),
    }

    def postfix(self) -> Callable:
        e = self.primary()
        while True:
            kind, tok = self.peek()
            if (kind, tok) == ("op", "."):
                self.next()
                nk, name = self.next()
                if nk != "ident":
                    raise CelCompileError(f"expected member name, got "
                                          f"{name!r}")
                if self.peek() == ("op", "("):
                    self.next()
                    args = []
                    if self.peek() != ("op", ")"):
                        args.append(self.or_())
                        while self.peek() == ("op", ","):
                            self.next()
                            args.append(self.or_())
                    self.expect(")")
                    if name == "size":
                        if args:
                            raise CelCompileError("size() takes no args")
                        e = (lambda f: lambda env: _size(f(env)))(e)
                        continue
                    method = self._METHODS.get(name)
                    if method is None:
                        raise CelCompileError(f"unknown method {name!r}")
                    if len(args) != 1:
                        raise CelCompileError(
                            f"{name}() takes exactly one argument")
                    e = (lambda f, a, m: lambda env:
                         m(f(env), a(env)))(e, args[0], method)
                else:
                    e = (lambda f, n: lambda env:
                         _field(f(env), n))(e, name)
            elif (kind, tok) == ("op", "["):
                self.next()
                idx = self.or_()
                self.expect("]")
                e = (lambda f, ix: lambda env:
                     _index(f(env), ix(env)))(e, idx)
            else:
                return e

    def primary(self) -> Callable:
        kind, tok = self.next()
        if kind == "float":
            v = float(tok)
            return lambda env: v
        if kind == "int":
            v = int(tok)
            return lambda env: v
        if kind == "string":
            v = _unquote(tok)
            return lambda env: v
        if kind == "ident":
            if tok in _KEYWORDS:
                v = _KEYWORDS[tok]
                return lambda env: v
            name = tok
            return lambda env: _var(env, name)
        if (kind, tok) == ("op", "("):
            e = self.or_()
            self.expect(")")
            return e
        if (kind, tok) == ("op", "["):
            items = []
            if self.peek() != ("op", "]"):
                items.append(self.or_())
                while self.peek() == ("op", ","):
                    self.next()
                    items.append(self.or_())
            self.expect("]")
            return lambda env, fs=tuple(items): [f(env) for f in fs]
        raise CelCompileError(f"unexpected token {tok!r}")


def _re_search(s: str, pattern: str) -> bool:
    try:
        return re.search(pattern, s) is not None
    except re.error as e:
        raise CelEvalError(f"invalid regular expression: {e}") from e


def _truthy(v: Any) -> bool:
    if not isinstance(v, bool):
        raise CelEvalError(f"non-boolean in boolean context: {v!r}")
    return v


def _ordered(a: Any, b: Any) -> bool:
    num = (int, float)
    if isinstance(a, num) and not isinstance(a, bool) \
            and isinstance(b, num) and not isinstance(b, bool):
        return True
    if isinstance(a, str) and isinstance(b, str):
        return True
    raise CelEvalError(f"cannot order {a!r} and {b!r}")


def _str(v: Any) -> str:
    if not isinstance(v, str):
        raise CelEvalError(f"string method on non-string {v!r}")
    return v


def _size(v: Any) -> int:
    if isinstance(v, (str, list, tuple, dict)):
        return len(v)
    raise CelEvalError(f"size() of unsupported type {type(v).__name__}")


def _var(env: dict, name: str) -> Any:
    if name not in env:
        raise CelEvalError(f"undeclared reference {name!r}")
    return env[name]


def _field(obj: Any, name: str) -> Any:
    if isinstance(obj, dict):
        if name not in obj:
            raise CelEvalError(f"no such key {name!r}")
        return obj[name]
    raise CelEvalError(f"no such field {name!r}")


def _index(obj: Any, key: Any) -> Any:
    if isinstance(obj, dict):
        if key not in obj:
            raise CelEvalError(f"no such key {key!r}")
        return obj[key]
    if isinstance(obj, (list, tuple)):
        if not isinstance(key, int) or isinstance(key, bool):
            raise CelEvalError("list index must be an integer")
        if not 0 <= key < len(obj):
            raise CelEvalError("index out of range")
        return obj[key]
    raise CelEvalError(f"cannot index {type(obj).__name__}")


_CACHE_MAX = 256
_cache: OrderedDict[str, Callable] = OrderedDict()


def compile_cel(expression: str) -> Callable[[dict], Any]:
    """Compile once, cache up to 256 programs (claims.go celCache)."""
    fn = _cache.get(expression)
    if fn is not None:
        _cache.move_to_end(expression)
        return fn
    fn = _Parser(_tokenize(expression)).parse()
    _cache[expression] = fn
    if len(_cache) > _CACHE_MAX:
        _cache.popitem(last=False)
    return fn


def evaluate(expression: str, env: dict) -> Any:
    return compile_cel(expression)(env)


def evaluate_predicate(expression: str, env: dict) -> bool:
    """Evaluate a selector expression that MUST yield a boolean — the
    upstream DRA compiler type-checks selectors to bool; this subset
    has no type checker, so the bool requirement is enforced at first
    evaluation instead."""
    out = compile_cel(expression)(env)
    if not isinstance(out, bool):
        raise CelEvalError(
            f"selector expression must evaluate to a boolean, got "
            f"{type(out).__name__}")
    return out
