"""The ctypes signatures in kueue_tpu_torch/ops/_build._ENTRY match the
``extern "C"`` entry points of kueue_tpu_torch/csrc/*.cu, on the CPU.

ctypes passes an argument by its declared type only: a pointer declared
as a C int is cut to 32 bits and a missing argument is read as garbage,
on the card and without an error. So every entry point is parsed from
its source and held against ``_ENTRY``: the symbol, the argument count
and each argument's type (pointer -> c_void_p, long long -> c_longlong,
int -> c_int), and the int return that carries the cudaError_t."""

import ctypes
import re

import pytest

from kueue_tpu_torch.ops import _build

C_TYPES = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int}
DECL = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', re.S)


def _c_type(param: str) -> str:
    """'const void* rank' -> 'void*'; 'long long n' -> 'long long'."""
    words = param.replace("*", " * ").split()[:-1]  # drop the name
    words = [w for w in words if w != "const"]
    return " ".join(words).replace(" *", "*")


def declarations(name: str) -> list:
    src = (_build.CSRC / f"{name}.cu").read_text()
    return [(ret, sym, [_c_type(p) for p in params.split(",")])
            for ret, sym, params in DECL.findall(src)]


def test_every_source_has_an_entry():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) \
        == sorted(_build._ENTRY)


@pytest.mark.parametrize("name", sorted(_build._ENTRY))
def test_entry_matches_its_extern_c_declaration(name):
    symbol, argtypes = _build._ENTRY[name]
    decls = declarations(name)
    assert [sym for _, sym, _ in decls] == [symbol]
    ret, _, params = decls[0]
    assert ret == "int"
    assert len(params) == len(argtypes), (params, argtypes)
    for i, (param, argtype) in enumerate(zip(params, argtypes)):
        assert param in C_TYPES, f"{name} argument {i}: unknown type {param}"
        assert C_TYPES[param] is argtype, \
            f"{name} argument {i}: {param} declared as {argtype.__name__}"


def test_parser_reads_pointers_and_integers():
    assert [_c_type(p) for p in ("const void* rank", "void *out",
                                 "long long n", "int cq_bytes")] \
        == ["void*", "void*", "long long", "int"]
