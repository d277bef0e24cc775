"""Wilkinson formula parser (tokenizer + recursive descent).

A copy of ``tabmat_tpu/formula/parser.py``: plain Python, no array code.
Grammar, in increasing binding strength:

    formula   := [expr "~"] expr
    expr      := term (("+" | "-") term)*
    term      := inter ("*" inter)*        # a*b expands to a + b + a:b
    inter     := factor (":" factor)*      # pure interaction
    factor    := "0" | "1" | IDENT | CALL | "(" expr ")"

``CALL`` covers function factors like ``C(x)``, ``np.log(x)``,
``bs(x, 3)`` — the parenthesized argument text is kept verbatim and
evaluated later against the data + context.  A braced factor ``{expr}``
(formulaic-style) is likewise kept verbatim (braces stripped) and
evaluated as arbitrary Python against the data + context.

Produces an ordered, deduplicated list of :class:`Term` (tuples of factor
strings) plus an intercept flag; ``-`` removes terms, ``0``/``1`` toggle
the intercept.
"""

import re
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Term:
    """An interaction term: an ordered tuple of factor expression strings."""

    factors: tuple[str, ...]

    @property
    def degree(self) -> int:
        return len(self.factors)

    def name(self, separator: str = ":") -> str:
        return separator.join(self.factors)

    def __repr__(self):
        return self.name() or "1"


_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<op>\*\*|[~+\-*:/()])
      | (?P<num>\d+(?:\.\d+)?)
      | (?P<ident>[A-Za-z_.][\w.]*)
      | (?P<other>\S)
    )""",
    re.VERBOSE,
)


def _tokenize(src: str) -> list[str]:
    tokens = []
    pos = 0
    while pos < len(src):
        # skip whitespace, then check for a braced python factor `{...}`
        while pos < len(src) and src[pos].isspace():
            pos += 1
        if pos < len(src) and src[pos] == "{":
            depth = 0
            start = pos
            while pos < len(src):
                if src[pos] == "{":
                    depth += 1
                elif src[pos] == "}":
                    depth -= 1
                    if depth == 0:
                        pos += 1
                        break
                pos += 1
            if depth != 0:
                raise ValueError(f"Unbalanced braces in formula: {src!r}")
            # keep the inner text verbatim; it evaluates as python later
            tokens.append(src[start + 1 : pos - 1].strip())
            continue
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            break
        pos = m.end()
        tok = m.group().strip()
        if not tok:
            continue
        # merge a function call: IDENT immediately followed by "(" grabs the
        # whole balanced-paren argument text verbatim
        if m.lastgroup == "ident" and pos < len(src) and src[pos] == "(":
            depth = 0
            start = pos
            while pos < len(src):
                if src[pos] == "(":
                    depth += 1
                elif src[pos] == ")":
                    depth -= 1
                    if depth == 0:
                        pos += 1
                        break
                pos += 1
            if depth != 0:
                raise ValueError(f"Unbalanced parentheses in formula: {src!r}")
            tok = tok + src[start:pos]
        tokens.append(tok)
    return tokens


class _Parser:
    def __init__(self, tokens: list[str]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> str:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    # expr := term (("+"|"-") term)*  — returns (added, removed, intercept_votes)
    def parse_expr(self):
        added: list[Term] = []
        removed: list[Term] = []
        votes: list[bool] = []

        def absorb(sign, terms, vote):
            if vote is not None:
                votes.append(vote if sign > 0 else not vote)
            (added if sign > 0 else removed).extend(terms)

        sign = 1
        absorb(sign, *self.parse_term())
        while self.peek() in ("+", "-"):
            sign = 1 if self.next() == "+" else -1
            absorb(sign, *self.parse_term())
        return added, removed, votes

    # term := inter (("*" | "/") inter | "**" NUMBER)*
    def parse_term(self):
        terms, vote = self.parse_inter()
        while self.peek() in ("*", "/", "**"):
            op = self.next()
            if op == "**":
                power_tok = self.next()
                try:
                    power = int(power_tok)
                except ValueError:
                    raise ValueError(
                        f"'**' requires an integer power, got {power_tok!r}"
                    )
                # (a+b)**n: all interactions of the terms up to order n,
                # with repeated factors within a term collapsed
                base = list(terms)
                expanded = list(terms)
                current = list(terms)
                for _ in range(power - 1):
                    current = [
                        _dedupe_factors(t.factors + b.factors)
                        for t in current
                        for b in base
                    ]
                    expanded.extend(current)
                terms = _dedupe_terms(expanded)
                continue
            rights, rvote = self.parse_inter()
            if op == "*":
                crossed = [
                    Term(t.factors + r.factors) for t in terms for r in rights
                ]
                terms = terms + rights + crossed
            else:  # "/" — nesting: a / b == a + a:b
                crossed = [
                    Term(t.factors + r.factors) for t in terms for r in rights
                ]
                terms = terms + crossed
            if rvote is not None:
                vote = rvote
        return terms, vote

    # inter := factor (":" factor)*
    def parse_inter(self):
        terms, vote = self.parse_factor()
        while self.peek() == ":":
            self.next()
            rights, _ = self.parse_factor()
            terms = [Term(t.factors + r.factors) for t in terms for r in rights]
        return terms, vote

    # factor := "0" | "1" | IDENT/CALL | "(" expr ")"
    def parse_factor(self):
        tok = self.peek()
        if tok is None:
            raise ValueError("Unexpected end of formula")
        if tok == "(":
            self.next()
            added, removed, votes = self.parse_expr()
            if self.peek() != ")":
                raise ValueError("Expected ')' in formula")
            self.next()
            if removed:
                raise ValueError("'-' inside parentheses is not supported")
            vote = votes[-1] if votes else None
            return added, vote
        tok = self.next()
        if tok == "0":
            return [], False
        if tok == "1":
            return [], True
        if tok in ("~", "+", "-", "*", ":", ")"):
            raise ValueError(f"Unexpected token {tok!r} in formula")
        return [Term((tok,))], None


def _dedupe_factors(factors: tuple) -> Term:
    """Collapse repeated factors within an interaction (a:a == a)."""
    seen = []
    for f in factors:
        if f not in seen:
            seen.append(f)
    return Term(tuple(seen))


def _dedupe_terms(terms: list) -> list:
    """Order-preserving dedup by factor *set* (a:b == b:a for powers)."""
    seen = set()
    out = []
    for t in terms:
        key = frozenset(t.factors)
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def parse_formula(
    formula: str, include_intercept: bool = False
) -> tuple[Optional[list[Term]], list[Term], bool]:
    """Parse a formula; returns (lhs_terms | None, rhs_terms, intercept)."""
    if "~" in formula:
        lhs_src, rhs_src = formula.split("~", 1)
        lhs_terms = _parse_side(lhs_src, False)[0] if lhs_src.strip() else None
    else:
        lhs_terms = None
        rhs_src = formula

    rhs_terms, intercept = _parse_side(rhs_src, include_intercept)
    return lhs_terms, rhs_terms, intercept


def _parse_side(src: str, include_intercept: bool) -> tuple[list[Term], bool]:
    parser = _Parser(_tokenize(src))
    added, removed, votes = parser.parse_expr()
    if parser.peek() is not None:
        raise ValueError(f"Unexpected token {parser.peek()!r} in formula {src!r}")

    intercept = include_intercept
    for vote in votes:
        intercept = vote

    removed_set = set(removed)
    seen = set()
    terms = []
    for t in added:
        if t not in seen and t not in removed_set and t.factors:
            seen.add(t)
            terms.append(t)
    return terms, intercept
