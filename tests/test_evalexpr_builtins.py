"""Enumeration of the evalexpr 11.3.0 builtin surface.

The reference evaluates every `-i`/`--include-var`/`--include-sam`/`-f`
expression with evalexpr 11.3.0 (/root/reference/Cargo.toml:15;
/root/reference/src/pfile.rs:93-97), so a reference user can reach the
WHOLE builtin function table, not just the subset the README documents.
This test walks that table entry by entry with pinned expected values:

* every builtin from evalexpr 11.3.0's function list (min, max, len,
  floor/round/ceil, if, contains, contains_any, typeof, the math::
  family, the str:: family, bitand/bitor/bitxor/bitnot/shl/shr)
* Rust f64 edge semantics (NaN/inf instead of domain errors, ties-away
  rounding, i64 wrap-around on shl)
* tuple aggregation (`a, b`), `;` chains, and assignment operators —
  assignments parse but error at eval time because the reference hands
  evalexpr an IMMUTABLE context reference (pfile.rs:93-97)
* `random` is absent: the reference pins evalexpr WITHOUT the `rand`
  feature, so `random()` is an unbound function identifier there too.
"""

import math

import pytest

from pgen_tpu.query.ast import EMPTY, ExprError
from pgen_tpu.query.interp import eval_value
from pgen_tpu.query.parser import parse


def ev(src, ctx=None):
    return eval_value(parse(src), ctx or {})


# (expression, expected) — expected compared with variant-tagged equality:
# bools/ints exact by type, floats via special_eq (NaN equals NaN here).
VALUE_CASES = [
    # --- aggregation / misc builtins -------------------------------------
    ("min(3, 1, 2)", 1),
    ("min(3, 1.5)", 1.5),
    ("max(1, 2.5)", 2.5),
    ("max(4, 9, 2)", 9),
    ('len("abcd")', 4),
    ("len((1, 2, 3))", 3),
    ("floor(1.7)", 1.0),
    ("floor(-1.2)", -2.0),
    ("ceil(1.2)", 2.0),
    ("round(1.4)", 1.0),
    ("round(1.5)", 2.0),  # f64::round: ties AWAY from zero
    ("round(2.5)", 3.0),  # (Python's banker's rounding would say 2)
    ("round(-1.5)", -2.0),
    ("if(true, 1, 2)", 1),
    ('if(false, 1, "x")', "x"),
    ("contains((1, 2, 3), 2)", True),
    ("contains((1, 2, 3), 2.0)", False),  # variant-tagged: Int != Float
    ('contains(("a", "b"), "b")', True),
    ("contains_any((1, 2), (3, 2))", True),
    ("contains_any((1, 2), (3, 4))", False),
    ('typeof("x")', "string"),
    ("typeof(1)", "int"),
    ("typeof(1.5)", "float"),
    ("typeof(true)", "boolean"),
    ("typeof((1, 2))", "tuple"),
    # --- math:: one-arg family (Rust f64 methods: NaN/inf, no errors) ----
    ("math::ln(1)", 0.0),
    ("math::ln(0)", -math.inf),
    ("math::ln(-1)", math.nan),
    ("math::log(8, 2)", 3.0),
    ("math::log(0, 2)", -math.inf),
    ("math::log2(8)", 3.0),
    ("math::log10(1000)", 3.0),
    ("math::exp(0)", 1.0),
    ("math::exp(1)", math.e),
    ("math::exp2(3)", 8.0),
    ("math::pow(2, 10)", 1024.0),
    ("math::pow(0, -1)", math.inf),
    ("math::sqrt(4)", 2.0),
    ("math::sqrt(-1)", math.nan),
    ("math::cbrt(27)", 3.0),
    ("math::cbrt(-8)", -2.0),
    ("math::hypot(3, 4)", 5.0),
    ("math::abs(-3)", 3),
    ("math::abs(-3.5)", 3.5),
    ("math::sin(0)", 0.0),
    ("math::cos(0)", 1.0),
    ("math::tan(0)", 0.0),
    ("math::asin(1)", math.pi / 2),
    ("math::asin(2)", math.nan),
    ("math::acos(1)", 0.0),
    ("math::atan(0)", 0.0),
    ("math::atan2(1, 1)", math.pi / 4),
    ("math::sinh(0)", 0.0),
    ("math::cosh(0)", 1.0),
    ("math::tanh(0)", 0.0),
    ("math::asinh(0)", 0.0),
    ("math::acosh(1)", 0.0),
    ("math::acosh(0)", math.nan),
    ("math::atanh(1)", math.inf),
    ("math::atanh(-1)", -math.inf),
    ("math::atanh(2)", math.nan),
    # --- math:: predicates ------------------------------------------------
    ("math::is_nan(math::sqrt(-1))", True),
    ("math::is_nan(1.0)", False),
    ("math::is_finite(1.0)", True),
    ("math::is_finite(1.0 / 0.0)", False),
    ("math::is_infinite(1.0 / 0.0)", True),
    ("math::is_infinite(1.0)", False),
    ("math::is_normal(1.0)", True),
    ("math::is_normal(0.0)", False),
    # --- str:: family -----------------------------------------------------
    ('str::regex_matches("foobar", "foo.*r")', True),
    ('str::regex_matches("foobar", "^bar")', False),
    ('str::regex_replace("a1b2", "[0-9]", "_")', "a_b_"),
    ('str::to_lowercase("AbC")', "abc"),
    ('str::to_uppercase("AbC")', "ABC"),
    ('str::trim("  x  ")', "x"),
    ("str::from(1)", "1"),
    ("str::from(1.5)", "1.5"),
    ("str::from(true)", "true"),
    ('str::from((1, "a", true))', '(1, "a", true)'),
    ('str::substring("hello", 1, 3)', "el"),
    # --- bit functions (i64 semantics incl. wrap-around) ------------------
    ("bitand(6, 3)", 2),
    ("bitor(6, 3)", 7),
    ("bitxor(6, 3)", 5),
    ("bitnot(0)", -1),
    ("bitnot(-1)", 0),
    ("shl(1, 3)", 8),
    ("shl(1, 63)", -(1 << 63)),  # i64 wrap
    ("shr(8, 3)", 1),
    ("shr(-8, 1)", -4),  # arithmetic shift (sign-preserving)
    # --- tuple aggregation / chains ---------------------------------------
    ("(1, 2) == (1, 2)", True),
    ("(1, 2) == (1, 2.0)", False),  # element equality stays variant-tagged
    ('len(("a", (1, 2), 3))', 3),  # len counts top-level elements only
    ("1; 2", 2),  # chain value = last expression
    ('"x"; true', True),
]


def special_eq(got, want):
    if isinstance(want, bool) or isinstance(got, bool):
        return isinstance(got, bool) and isinstance(want, bool) and got == want
    if isinstance(want, float):
        if not isinstance(got, float):
            return False
        if math.isnan(want):
            return math.isnan(got)
        if math.isinf(want):
            return got == want
        return got == pytest.approx(want)
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("src,want", VALUE_CASES, ids=[c[0] for c in VALUE_CASES])
def test_builtin_value(src, want):
    got = ev(src)
    assert special_eq(got, want), f"{src} -> {got!r}, expected {want!r}"


def test_trailing_semicolon_yields_empty():
    assert ev("1; 2;") is EMPTY
    assert ev("typeof(())") == "empty"


# (expression, error-substring) — entries that must ERROR, matching
# evalexpr's error class for the same input.
ERROR_CASES = [
    ("len(1)", "len"),  # type error: Int has no length
    ("min()", "min"),  # empty aggregation
    ('min(1, "a")', "min"),  # non-numeric aggregation member
    ('floor("x")', "floor"),
    ("if(1, 2, 3)", "if"),  # non-Boolean condition
    ('math::ln("x")', "math::ln"),
    ("math::pow(1)", "math::pow"),  # wrong arity
    ("bitand(1.5, 2)", "bitand"),  # bit fns demand Int
    ("shl(1, 64)", "shl"),  # shift out of i64 range
    ("str::substring(1, 2, 3)", "str::substring"),
    ("random()", "not bound"),  # rand feature NOT enabled in the reference
    ("nosuch_function(1)", "not bound"),
]


@pytest.mark.parametrize("src,msg", ERROR_CASES, ids=[c[0] for c in ERROR_CASES])
def test_builtin_error(src, msg):
    with pytest.raises(ExprError, match=msg.replace("(", "\\(")):
        ev(src)


def test_assignment_operators_error_on_immutable_context():
    # every assignment form parses (evalexpr grammar) and errors at eval
    # (the reference's context reference is immutable, pfile.rs:93-97)
    for src in [
        "x = 1",
        "x += 1",
        "x -= 1",
        "x *= 2",
        "x /= 2",
        "x %= 2",
        "x ^= 2",
        "x &&= true",
        "x ||= false",
    ]:
        with pytest.raises(ExprError, match="immutable"):
            ev(src, {"x": "1"})
