"""SQL analytics surface — the device-first analogue of the fork's
Parquet/DataFusion engine.

Counterpart of the JAX package's `analytics/sql.py`, carried over whole:
it is host code, and its SQL compiles onto the root's search requests, so
its aggregates run the port's device agg programs.

Role of the reference's `quickwit-datafusion` / `quickwit-df-core`
(`src/sources/metrics/table_provider.rs:1`, `service.rs:1`, mounted at
`quickwit-serve/src/datafusion_api/setup.rs:201`): a SQL aggregation
surface over the columnar data. The fork bolts a SECOND engine
(DataFusion over Parquet) beside tantivy; here the design is unified —
SQL **compiles onto the same device kernels** the search path runs
(QueryAst predicate → dense masks, GROUP BY → terms/date_histogram
bucket spaces, aggregates → the mergeable metric states), so analytics
inherits the whole distributed substrate: split pruning, fan-out, the
scatter-gather merge tree, caches, and admission. There is no second
storage format to compact and no second executor to schedule.

Dialect (vertical slice):

    SELECT <agg|col|DATE_TRUNC('unit', col)|<agg> OVER (...)> [AS a], ...
    FROM <index> [alias]
    [ [LEFT|INNER] JOIN <index> <alias> ON a.k = b.k [AND ...] ]*
    [WHERE <col op literal | col op (SELECT ...) |
            col [NOT] IN (list | SELECT ...)> [AND|OR ...] ]
    [GROUP BY <col | DATE_TRUNC('unit', col)> [, ...]]     -- any depth
    [HAVING <agg|alias> <op> <number> [AND ...]]
    [ORDER BY <alias|expr> [ASC|DESC]]
    [LIMIT n] [OFFSET n]

Aggregates: COUNT(*), COUNT(col), COUNT(DISTINCT col) /
APPROX_COUNT_DISTINCT (device HLL cardinality), SUM, AVG, MIN, MAX,
STDDEV, VARIANCE, APPROX_PERCENTILE(col, p) — the last rides the DDSketch percentile
kernels (the fork's sketch UDFs, `quickwit-datafusion/src/sources/
metrics/sketch_udf.rs`). GROUP BY chains compile onto the arbitrary-
depth nested bucket spaces, so N keys = one device pass.
Operators: = != <> < <= > >= ; string/number literals; AND/OR + parens.

Relational tail (the role of the fork's DataFusion operators the device
path has no analogue for):
- Subqueries in WHERE: scalar comparisons, [NOT] IN membership, and
  [NOT] EXISTS with a single equality correlation (decorrelated onto
  the IN machinery); resolved against live results first, so the OUTER
  query still compiles onto the device scan (membership becomes a
  term-set mask).
- Window functions: ROW_NUMBER / RANK / COUNT / SUM / AVG / MIN / MAX
  OVER (PARTITION BY ... [ORDER BY ...]); with ORDER BY the frame is the
  SQL default running frame (peers included).
- JOINs: equality INNER/LEFT joins between indexes. Single-table WHERE
  conjuncts push down through each side's device scan; the join itself
  and its grouped tail run host-side over the materialized sides.
JOIN sides and window inputs are capped at MATERIALIZE_CAP rows — the
host tail is for the (already reduced) relational step, not for full
scans; pure aggregation stays uncapped on the device path.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional

from ..query import ast as Q

_TRUNC_MICROS = {
    "second": 1_000_000, "minute": 60_000_000, "hour": 3_600_000_000,
    "day": 86_400_000_000, "week": 7 * 86_400_000_000,
}


class SqlError(ValueError):
    pass


# --------------------------------------------------------------------------
# lexer

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<number>-?\d+(?:\.\d+)?)
    | (?P<string>'(?:[^'\\]|\\.)*')
    | (?P<qident>"[^"]*")
    | (?P<op><=|>=|!=|<>|=|<|>|\(|\)|,|\*)
    | (?P<word>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""", re.VERBOSE)

_KEYWORDS = {"select", "from", "where", "group", "by", "order", "limit",
             "offset", "having", "and", "or", "as", "asc", "desc",
             "count", "sum", "avg", "min", "max", "stddev", "variance",
             "approx_percentile", "approx_count_distinct", "date_trunc",
             "distinct", "join", "left", "inner", "on", "over",
             "partition", "row_number", "rank", "in", "not", "exists"}

# Keywords new to the relational tail are CONTEXTUAL: where the grammar
# expects an identifier they still parse as column names, so existing
# indexes with fields named e.g. `rank` or `partition` keep working
# (`"quoted"` identifiers are the universal escape hatch).
_CONTEXTUAL = {"join", "left", "inner", "on", "over", "partition",
               "row_number", "rank", "in", "not", "exists"}

# Materialization cap for the host-side relational layer (JOIN sides and
# window-function inputs). Joins/windows run over rows fetched through
# the distributed search path; beyond this the query must be narrowed
# (the device agg path has no such cap — only the relational layer).
MATERIALIZE_CAP = 65536


def _tokenize(text: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise SqlError(f"cannot tokenize SQL at {text[pos:pos+20]!r}")
        pos = m.end()
        if m.group("number") is not None:
            out.append(("number", m.group("number")))
        elif m.group("string") is not None:
            out.append(("string",
                        m.group("string")[1:-1].replace("\\'", "'")))
        elif m.group("qident") is not None:
            out.append(("ident", m.group("qident")[1:-1]))
        elif m.group("op") is not None:
            out.append(("op", m.group("op")))
        else:
            word = m.group("word")
            kind = "kw" if word.lower() in _KEYWORDS else "ident"
            out.append((kind, word.lower() if kind == "kw" else word))
    return out


# --------------------------------------------------------------------------
# AST

@dataclass(frozen=True)
class SelectItem:
    kind: str          # "count_star" | "agg" | "col" | "trunc" | "window"
    func: Optional[str] = None
    column: Optional[str] = None
    unit: Optional[str] = None
    alias: Optional[str] = None
    percent: Optional[float] = None   # approx_percentile
    partition: tuple[str, ...] = ()               # window: PARTITION BY
    win_order: Optional[tuple[str, bool]] = None  # window: ORDER BY

    @property
    def name(self) -> str:
        if self.alias:
            return self.alias
        if self.kind == "count_star":
            return "count(*)"
        if self.kind == "agg":
            if self.func == "approx_percentile":
                return f"approx_percentile({self.column}, {self.percent:g})"
            return f"{self.func}({self.column})"
        if self.kind == "trunc":
            return f"date_trunc('{self.unit}', {self.column})"
        if self.kind == "window":
            base = (f"{self.func}({self.column})" if self.column
                    else f"{self.func}()")
            return f"{base} over"
        return self.column or ""


@dataclass(frozen=True)
class JoinClause:
    index: str
    alias: str
    on: tuple[tuple[str, str], ...]   # (left qualified, right qualified)
    left_outer: bool = False


@dataclass(frozen=True)
class SubqueryPred:
    """A WHERE leaf whose right-hand side is a subquery; resolved
    against live results (scalar comparison or IN/NOT IN membership,
    or [NOT] EXISTS decorrelation) before the predicate is compiled
    onto the device path. `column` is empty for EXISTS."""
    column: str
    op: str              # = != <> < <= > >= in not_in exists not_exists
    query: "SqlQuery"


@dataclass(frozen=True)
class ColumnEq:
    """`a.k = b.k` — a column-to-column equality leaf. Only meaningful
    as the correlation predicate inside an EXISTS subquery (the device
    scan has no cross-doc comparisons); anywhere else it resolves to a
    clear SqlError."""
    left: str
    right: str


@dataclass
class SqlQuery:
    index: str
    select: list[SelectItem]
    where: Optional[Q.QueryAst] = None
    group_by: list[SelectItem] = field(default_factory=list)
    order_by: Optional[tuple[str, bool]] = None  # (name, desc)
    having: list[tuple[str, str, float]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    alias: Optional[str] = None
    joins: list[JoinClause] = field(default_factory=list)


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self):
        token = self.peek()
        if token is None:
            raise SqlError("unexpected end of query")
        self.pos += 1
        return token

    def expect(self, kind: str, value: Optional[str] = None):
        token = self.next()
        if token[0] != kind or (value is not None and token[1] != value):
            raise SqlError(f"expected {value or kind}, got {token[1]!r}")
        return token

    def accept(self, kind: str, value: Optional[str] = None) -> bool:
        token = self.peek()
        if token and token[0] == kind and (value is None
                                           or token[1] == value):
            self.pos += 1
            return True
        return False

    def _ident(self) -> str:
        """An identifier; contextual keywords double as column names."""
        token = self.next()
        if token[0] == "ident" or (token[0] == "kw"
                                   and token[1] in _CONTEXTUAL):
            return token[1]
        raise SqlError(f"expected identifier, got {token[1]!r}")

    # --- grammar -------------------------------------------------------
    def parse(self) -> SqlQuery:
        q = self.parse_select()
        if self.peek() is not None:
            raise SqlError(f"unexpected trailing token {self.peek()[1]!r}")
        return q

    def _table_alias(self) -> Optional[str]:
        if self.accept("kw", "as"):
            return self.expect("ident")[1]
        token = self.peek()
        if token and token[0] == "ident":
            self.pos += 1
            return token[1]
        return None

    def parse_select(self) -> SqlQuery:
        self.expect("kw", "select")
        select = [self.select_item()]
        while self.accept("op", ","):
            select.append(self.select_item())
        self.expect("kw", "from")
        index = self.expect("ident")[1]
        alias = self._table_alias()
        joins: list[JoinClause] = []
        while True:
            left_outer = False
            if self.accept("kw", "left"):
                left_outer = True
                self.expect("kw", "join")
            elif self.accept("kw", "inner"):
                self.expect("kw", "join")
            elif not self.accept("kw", "join"):
                break
            j_index = self.expect("ident")[1]
            j_alias = self._table_alias()
            if alias is None or j_alias is None:
                raise SqlError("JOIN requires table aliases "
                               "(FROM a x JOIN b y ON x.k = y.k)")
            self.expect("kw", "on")
            on = [self._on_equality()]
            while self.accept("kw", "and"):
                on.append(self._on_equality())
            joins.append(JoinClause(j_index, j_alias, tuple(on),
                                    left_outer))
        where = None
        if self.accept("kw", "where"):
            where = self.predicate()
        group_by: list[SelectItem] = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by.append(self.group_key())
            while self.accept("op", ","):
                group_by.append(self.group_key())
        having: list[tuple[str, str, float]] = []
        if self.accept("kw", "having"):
            having.append(self.having_clause())
            while self.accept("kw", "and"):
                having.append(self.having_clause())
        order_by = None
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            name = self.order_target()
            desc = False
            if self.accept("kw", "desc"):
                desc = True
            else:
                self.accept("kw", "asc")
            order_by = (name, desc)
        limit = None
        if self.accept("kw", "limit"):
            limit = int(self.expect("number")[1])
        offset = 0
        if self.accept("kw", "offset"):
            offset = int(self.expect("number")[1])
        return SqlQuery(index=index, select=select, where=where,
                        group_by=group_by, order_by=order_by,
                        having=having, limit=limit, offset=offset,
                        alias=alias, joins=joins)

    def _on_equality(self) -> tuple[str, str]:
        lhs = self._ident()
        self.expect("op", "=")
        rhs = self._ident()
        return (lhs, rhs)

    def having_clause(self) -> tuple[str, str, float]:
        item = self.select_item()
        if item.kind == "star":
            raise SqlError("HAVING takes an aggregate or alias")
        op = self.expect("op")[1]
        if op not in ("=", "!=", "<>", "<", "<=", ">", ">="):
            raise SqlError(f"unsupported HAVING operator {op!r}")
        value = float(self.expect("number")[1])
        return (item.name, op, value)

    def _maybe_over(self, item: SelectItem) -> SelectItem:
        """`<agg> OVER (PARTITION BY ... [ORDER BY ...])` turns an
        aggregate into a window item (computed host-side over
        materialized rows, cap `MATERIALIZE_CAP`)."""
        if not self.accept("kw", "over"):
            return item
        if item.kind not in ("count_star", "agg") and \
                item.func not in ("row_number", "rank"):
            raise SqlError("OVER applies to aggregate functions")
        if item.func in ("count_distinct", "approx_percentile",
                         "stddev", "variance"):
            raise SqlError(
                f"{item.func} is not supported as a window function")
        self.expect("op", "(")
        partition: list[str] = []
        if self.accept("kw", "partition"):
            self.expect("kw", "by")
            partition.append(self._ident())
            while self.accept("op", ","):
                partition.append(self._ident())
        win_order = None
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            col = self._ident()
            desc = False
            if self.accept("kw", "desc"):
                desc = True
            else:
                self.accept("kw", "asc")
            win_order = (col, desc)
        self.expect("op", ")")
        func = "count" if item.kind == "count_star" else item.func
        return SelectItem("window", func=func, column=item.column,
                          partition=tuple(partition), win_order=win_order,
                          alias=item.alias or self._alias())

    def select_item(self) -> SelectItem:
        token = self.next()
        if token == ("op", "*") or token[0] == "number":
            # `SELECT 1` / `SELECT *`: only meaningful inside EXISTS
            # subqueries (the row content is irrelevant there)
            return SelectItem("star", alias=self._alias())
        if token[0] == "kw" and token[1] in ("row_number", "rank") \
                and self.peek() == ("op", "("):
            self.next()  # (
            self.expect("op", ")")
            item = SelectItem("agg", func=token[1], alias=self._alias())
            if not (self.peek() and self.peek() == ("kw", "over")):
                raise SqlError(f"{token[1]}() requires an OVER clause")
            return self._maybe_over(item)
        if token[0] == "kw" and token[1] in _CONTEXTUAL:
            # contextual keyword in identifier position = a column name
            token = ("ident", token[1])
        if token[0] == "kw" and token[1] == "count":
            self.expect("op", "(")
            if self.accept("op", "*"):
                self.expect("op", ")")
                return self._maybe_over(
                    SelectItem("count_star", alias=self._alias()))
            if self.accept("kw", "distinct"):
                # COUNT(DISTINCT col) rides the device HLL cardinality
                # kernel (approximate, like every engine at scale)
                column = self._ident()
                self.expect("op", ")")
                return self._maybe_over(
                    SelectItem("agg", func="count_distinct",
                               column=column, alias=self._alias()))
            column = self._ident()
            self.expect("op", ")")
            return self._maybe_over(
                SelectItem("agg", func="count", column=column,
                           alias=self._alias()))
        if token[0] == "kw" and token[1] == "approx_count_distinct":
            self.expect("op", "(")
            column = self._ident()
            self.expect("op", ")")
            return self._maybe_over(
                SelectItem("agg", func="count_distinct", column=column,
                           alias=self._alias()))
        if token[0] == "kw" and token[1] in ("sum", "avg", "min", "max",
                                             "stddev", "variance"):
            self.expect("op", "(")
            column = self._ident()
            self.expect("op", ")")
            return self._maybe_over(
                SelectItem("agg", func=token[1], column=column,
                           alias=self._alias()))
        if token[0] == "kw" and token[1] == "approx_percentile":
            self.expect("op", "(")
            column = self._ident()
            self.expect("op", ",")
            percent = float(self.expect("number")[1])
            if not 0 < percent < 100:
                raise SqlError("approx_percentile takes a percent in (0,100)")
            self.expect("op", ")")
            return self._maybe_over(
                SelectItem("agg", func="approx_percentile", column=column,
                           percent=percent, alias=self._alias()))
        if token[0] == "kw" and token[1] == "date_trunc":
            self.expect("op", "(")
            unit = self.expect("string")[1].lower()
            if unit not in _TRUNC_MICROS:
                raise SqlError(f"unsupported date_trunc unit {unit!r}")
            self.expect("op", ",")
            column = self._ident()
            self.expect("op", ")")
            return SelectItem("trunc", column=column, unit=unit,
                              alias=self._alias())
        if token[0] == "ident":
            return SelectItem("col", column=token[1], alias=self._alias())
        raise SqlError(f"unexpected token {token[1]!r} in SELECT")

    def _alias(self) -> Optional[str]:
        if self.accept("kw", "as"):
            return self.next()[1]
        return None

    def group_key(self) -> SelectItem:
        item = self.select_item()
        if item.kind not in ("col", "trunc"):
            raise SqlError("GROUP BY takes columns or DATE_TRUNC(...)")
        return item

    def order_target(self) -> str:
        # an alias, a bare column, count(*) or fn(col)
        item = self.select_item()
        if item.kind == "star":
            raise SqlError("ORDER BY position numbers are not "
                           "supported; use the column name or alias")
        return item.name

    # --- WHERE ---------------------------------------------------------
    def predicate(self) -> Q.QueryAst:
        left = self.pred_term()
        while True:
            if self.accept("kw", "or"):
                right = self.pred_term()
                left = Q.Bool(should=(left, right), minimum_should_match=1)
            else:
                break
        return left

    def pred_term(self) -> Q.QueryAst:
        left = self.pred_factor()
        while self.accept("kw", "and"):
            right = self.pred_factor()
            left = Q.Bool(must=(left, right))
        return left

    def _exists_subquery(self, negate: bool) -> Q.QueryAst:
        self.expect("op", "(")
        sub = self.parse_select()
        self.expect("op", ")")
        return SubqueryPred("", "not_exists" if negate else "exists", sub)

    def pred_factor(self) -> Q.QueryAst:
        if self.accept("op", "("):
            inner = self.predicate()
            self.expect("op", ")")
            return inner
        # [NOT] EXISTS (SELECT ...) — contextual: `exists`/`not` still
        # parse as column names unless the subquery shape follows
        if self.peek() == ("kw", "exists") \
                and self.tokens[self.pos + 1: self.pos + 2] \
                == [("op", "(")]:
            self.next()
            return self._exists_subquery(negate=False)
        if self.peek() == ("kw", "not") \
                and self.tokens[self.pos + 1: self.pos + 2] \
                == [("kw", "exists")]:
            self.next()
            self.next()
            return self._exists_subquery(negate=True)
        column = self._ident()
        if self.accept("kw", "not"):
            self.expect("kw", "in")
            return self._in_subquery(column, negate=True)
        if self.accept("kw", "in"):
            return self._in_subquery(column, negate=False)
        op = self.expect("op")[1]
        if op in ("=", "!=", "<>", "<", "<=", ">", ">=") \
                and self.peek() == ("op", "(") \
                and self.pos + 1 < len(self.tokens) \
                and self.tokens[self.pos + 1] == ("kw", "select"):
            self.next()  # (
            sub = self.parse_select()
            self.expect("op", ")")
            return SubqueryPred(column, op, sub)
        if op == "=" and self.peek() is not None \
                and (self.peek()[0] == "ident"
                     or (self.peek()[0] == "kw"
                         and self.peek()[1] in _CONTEXTUAL)):
            # column = column: EXISTS correlation predicate
            return ColumnEq(column, self._ident())
        kind, literal = self.next()
        if kind not in ("number", "string"):
            raise SqlError(f"expected literal after {op}, got {literal!r}")
        if op == "=":
            return Q.Term(column, str(literal), verbatim=True)
        if op in ("!=", "<>"):
            return Q.Bool(must=(Q.MatchAll(),),
                          must_not=(Q.Term(column, str(literal),
                                           verbatim=True),))
        bound = Q.RangeBound(literal if kind == "string"
                             else float(literal), op in ("<=", ">="))
        if op in (">", ">="):
            return Q.Range(column, lower=bound)
        return Q.Range(column, upper=bound)

    def _in_subquery(self, column: str, negate: bool) -> Q.QueryAst:
        self.expect("op", "(")
        if self.peek() == ("kw", "select"):
            sub = self.parse_select()
            self.expect("op", ")")
            return SubqueryPred(column, "not_in" if negate else "in", sub)
        values = [str(self.next()[1])]
        while self.accept("op", ","):
            values.append(str(self.next()[1]))
        self.expect("op", ")")
        member: Q.QueryAst = Q.TermSet({column: tuple(values)})
        if negate:
            return Q.Bool(must=(Q.MatchAll(),), must_not=(member,))
        return member


def parse_sql(text: str) -> SqlQuery:
    return _Parser(_tokenize(text)).parse()


# --------------------------------------------------------------------------
# compilation onto the search/agg substrate

def _metric_body(item: SelectItem) -> dict:
    if item.kind == "count_star":
        return {}
    if item.func == "count":
        return {"value_count": {"field": item.column}}
    if item.func == "count_distinct":
        return {"cardinality": {"field": item.column}}
    if item.func == "approx_percentile":
        return {"percentiles": {"field": item.column,
                                "percents": [item.percent]}}
    if item.func in ("stddev", "variance"):
        return {"extended_stats": {"field": item.column}}
    return {item.func: {"field": item.column}}


def _metric_value(item: SelectItem, agg_result: dict):
    if item.func == "approx_percentile":
        return (agg_result.get("values") or {}).get(f"{item.percent:g}")
    if item.func == "stddev":
        return agg_result.get("std_deviation")
    if item.func == "variance":
        return agg_result.get("variance")
    return agg_result.get("value")


def execute_sql(text: str, search) -> dict[str, Any]:
    """Parse + compile + run one SQL statement. `search(index_id,
    query_ast, max_hits, aggs)` is the injected search entry (the node's
    root searcher) — analytics rides the full distributed query path.
    Returns {"columns": [...], "rows": [[...], ...]}."""
    return _execute(parse_sql(text), search)


def _execute(q: SqlQuery, search) -> dict[str, Any]:
    if any(s.kind == "star" for s in q.select):
        raise SqlError(
            "SELECT * / SELECT 1 is only supported inside EXISTS "
            "subqueries; name the columns")
    if q.joins:
        return _run_join(q, search)
    ast = _resolve_subqueries(q.where, search, q.alias) \
        if q.where is not None else Q.MatchAll()
    aggregates = [s for s in q.select
                  if s.kind in ("agg", "count_star")]
    windows = [s for s in q.select if s.kind == "window"]
    plain_cols = [s for s in q.select if s.kind in ("col", "trunc")]

    if windows:
        if q.group_by:
            raise SqlError(
                "window functions cannot be combined with GROUP BY")
        if aggregates:
            raise SqlError(
                "window functions cannot be mixed with plain aggregates")
        if any(s.kind == "trunc" for s in q.select):
            raise SqlError(
                "DATE_TRUNC is not supported alongside window functions")
        return _run_window(q, ast, search)
    if q.group_by:
        return _run_grouped(q, ast, aggregates, search)
    if aggregates:
        if plain_cols:
            raise SqlError(
                "non-aggregated columns require GROUP BY")
        return _run_global_aggs(q, ast, aggregates, search)
    if any(s.kind == "trunc" for s in q.select):
        raise SqlError(
            "DATE_TRUNC in a plain projection requires GROUP BY")
    return _run_projection(q, ast, search)


# --------------------------------------------------------------------------
# subqueries: resolved against live results, then compiled to plain
# predicates so the outer query still rides the device path untouched

def _resolve_subqueries(node, search, outer_alias=None):
    if isinstance(node, SubqueryPred):
        return _resolve_one_subquery(node, search, outer_alias)
    if isinstance(node, ColumnEq):
        raise SqlError(
            f"column-to-column comparison {node.left} = {node.right} is "
            "only supported in JOIN ON clauses and as the correlation "
            "predicate of an EXISTS subquery")
    if isinstance(node, Q.Bool):
        return Q.Bool(
            must=tuple(_resolve_subqueries(c, search, outer_alias)
                       for c in node.must),
            must_not=tuple(_resolve_subqueries(c, search, outer_alias)
                           for c in node.must_not),
            should=tuple(_resolve_subqueries(c, search, outer_alias)
                         for c in node.should),
            filter=tuple(_resolve_subqueries(c, search, outer_alias)
                         for c in node.filter),
            minimum_should_match=node.minimum_should_match)
    return node


def _resolve_one_subquery(pred: SubqueryPred, search,
                          outer_alias=None) -> Q.QueryAst:
    sub = pred.query
    if sub.joins:
        raise SqlError("subqueries cannot contain JOINs")
    if pred.op in ("exists", "not_exists"):
        return _decorrelate_exists(pred, search, outer_alias)
    if pred.op in ("in", "not_in"):
        if len(sub.select) != 1:
            raise SqlError("IN subquery must select exactly one column")
        # an un-limited plain projection drains up to cap+1, not the
        # projection default of 100 — membership wants ALL values, and
        # the extra row makes overflow DETECTABLE instead of a silent
        # truncation (NOT IN would otherwise return rows it must drop)
        if sub.limit is None and not sub.group_by and not any(
                s.kind in ("agg", "count_star") for s in sub.select):
            sub = SqlQuery(**{**sub.__dict__,
                              "limit": MATERIALIZE_CAP + 1})
        rows = _execute(sub, search)["rows"]
        if len(rows) > MATERIALIZE_CAP:
            raise SqlError(
                f"IN subquery produced more than {MATERIALIZE_CAP} values")
        values = tuple(dict.fromkeys(
            _sql_str(r[0]) for r in rows if r and r[0] is not None))
        if pred.op == "in":
            return Q.TermSet({pred.column: values}) if values \
                else Q.MatchNone()
        if not values:
            return Q.MatchAll()
        return Q.Bool(must=(Q.MatchAll(),),
                      must_not=(Q.TermSet({pred.column: values}),))
    rows = _execute(sub, search)["rows"]
    if not rows:
        # SQL: a 0-row scalar subquery is NULL; any comparison with
        # NULL is unknown -> matches nothing
        return Q.MatchNone()
    if len(rows) != 1 or len(rows[0]) != 1:
        raise SqlError("scalar subquery must return exactly one value "
                       f"(got {len(rows)} rows)")
    value = rows[0][0]
    if value is None:
        return Q.MatchNone()
    if pred.op == "=":
        return Q.Term(pred.column, _sql_str(value), verbatim=True)
    if pred.op in ("!=", "<>"):
        return Q.Bool(must=(Q.MatchAll(),),
                      must_not=(Q.Term(pred.column, _sql_str(value),
                                       verbatim=True),))
    try:
        numeric = float(value)
    except (TypeError, ValueError):
        raise SqlError(
            f"scalar subquery for {pred.op!r} must return a number "
            f"(got {value!r})")
    bound = Q.RangeBound(numeric, pred.op in ("<=", ">="))
    if pred.op in (">", ">="):
        return Q.Range(pred.column, lower=bound)
    return Q.Range(pred.column, upper=bound)


def _contains_column_eq(node) -> bool:
    if isinstance(node, ColumnEq):
        return True
    if isinstance(node, Q.Bool):
        return any(_contains_column_eq(c)
                   for group in (node.must, node.must_not,
                                 node.should, node.filter)
                   for c in group)
    return False


def _decorrelate_exists(pred: SubqueryPred, search,
                        outer_alias) -> Q.QueryAst:
    """[NOT] EXISTS with an equality correlation decorrelates onto the
    IN machinery: `EXISTS (SELECT 1 FROM b x WHERE x.k = k AND <preds>)`
    becomes `k [NOT] IN (SELECT x.k FROM b WHERE <preds>)`, so the
    outer query STILL compiles onto the device scan (the fork's
    DataFusion plans the same rewrite). NULL semantics follow EXISTS:
    a missing outer key never matches (and NOT EXISTS keeps it)."""
    sub = pred.query
    negate = pred.op == "not_exists"
    if sub.group_by or sub.having or sub.order_by \
            or sub.limit is not None or sub.offset:
        raise SqlError(
            "EXISTS subqueries support only FROM and WHERE "
            "(GROUP BY/HAVING/ORDER BY/LIMIT would be silently "
            "meaningless after decorrelation)")
    if any(s.kind in ("agg", "count_star") for s in sub.select):
        # SQL: an ungrouped aggregate subquery yields EXACTLY one row
        # (COUNT over zero rows is still the row [0]), so EXISTS over
        # it is constant-true — fold, matching Postgres/DataFusion
        return Q.MatchNone() if negate else Q.MatchAll()
    inner_prefix = (sub.alias + ".") if sub.alias else None
    outer_prefix = (outer_alias + ".") if outer_alias else None

    def strip_outer(name: str) -> str:
        if outer_prefix and name.startswith(outer_prefix):
            return name[len(outer_prefix):]
        return name

    correlations: list[tuple[str, str]] = []   # (outer col, inner col)
    inner_preds: list[Q.QueryAst] = []
    for conj in _conjuncts(sub.where) if sub.where is not None else []:
        if isinstance(conj, ColumnEq):
            if inner_prefix is None:
                raise SqlError(
                    "correlated EXISTS requires an alias on the inner "
                    "table (EXISTS (SELECT 1 FROM other x "
                    "WHERE x.k = k))")
            sides = (conj.left, conj.right)
            inner_side = [s for s in sides
                          if s.startswith(inner_prefix)]
            outer_side = [s for s in sides
                          if not s.startswith(inner_prefix)]
            if len(inner_side) != 1:
                raise SqlError(
                    f"EXISTS correlation {conj.left} = {conj.right} "
                    f"must compare one {sub.alias!r}-column with one "
                    "outer column")
            correlations.append((strip_outer(outer_side[0]),
                                 inner_side[0][len(inner_prefix):]))
            continue
        if _contains_column_eq(conj):
            raise SqlError(
                "the EXISTS correlation (col = col) must be a "
                "top-level AND conjunct of the subquery's WHERE — "
                "not nested under OR/NOT")
        fields = _pred_fields(conj)
        if inner_prefix is not None and any(
                not f.startswith(inner_prefix) for f in fields
                if "." in f
                and f.split(".", 1)[0] == (outer_alias or "")):
            raise SqlError(
                "outer-column predicates inside EXISTS must be the "
                "equality correlation (col = col)")
        inner_preds.append(_strip_alias(conj, sub.alias)
                           if sub.alias else conj)
    if len(correlations) > 1:
        raise SqlError(
            "EXISTS supports exactly one equality correlation")
    inner_where = Q.Bool(must=tuple(inner_preds)) if inner_preds \
        else None
    if not correlations:
        # uncorrelated EXISTS: constant-folds on whether ANY row matches
        probe = SqlQuery(index=sub.index,
                         select=[SelectItem("count_star")],
                         where=inner_where, alias=sub.alias)
        [[count]] = _execute(probe, search)["rows"]
        non_empty = bool(count)
        return Q.MatchAll() if non_empty != negate else Q.MatchNone()
    outer_col, inner_col = correlations[0]
    membership = SqlQuery(
        index=sub.index,
        select=[SelectItem("col", column=inner_col)],
        where=inner_where, alias=sub.alias)
    return _resolve_one_subquery(
        SubqueryPred(outer_col, "not_in" if negate else "in",
                     membership), search)


def _sql_str(value) -> str:
    """Literal normalization matching the parser's number formatting: a
    whole float renders as its integer spelling (Term lookups are
    string-keyed)."""
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return str(value)


def _agg_requests(aggregates: list[SelectItem]) -> dict:
    """One agg entry per DISTINCT metric body: SELECT STDDEV(x),
    VARIANCE(x) shares one extended_stats kernel; `_agg_key` maps each
    select item to its entry."""
    aggs = {}
    seen: dict[str, str] = {}
    for i, item in enumerate(aggregates):
        if item.kind == "count_star":
            continue  # doc_count / num_hits covers it
        body = _metric_body(item)
        canon = repr(sorted(body.items()))
        if canon not in seen:
            seen[canon] = f"a{i}"
            aggs[f"a{i}"] = body
    return aggs


def _agg_key(aggregates: list[SelectItem], item: SelectItem) -> str:
    canon = repr(sorted(_metric_body(item).items()))
    for i, other in enumerate(aggregates):
        if other.kind != "count_star" and \
                repr(sorted(_metric_body(other).items())) == canon:
            return f"a{i}"
    raise SqlError(f"internal: no agg entry for {item.name!r}")


def _run_global_aggs(q: SqlQuery, ast, aggregates, search):
    response = search(q.index, ast, 0, _agg_requests(aggregates) or None)
    row = []
    for i, item in enumerate(aggregates):
        if item.kind == "count_star":
            row.append(response.num_hits)
        else:
            row.append(_metric_value(
                item, (response.aggregations or {}).get(
                    _agg_key(aggregates, item), {})))
    rows = _apply_having(q, [row])
    return {"columns": [s.name for s in q.select], "rows": rows}


def _group_agg_body(key: SelectItem) -> dict:
    if key.kind == "trunc":
        interval_micros = _TRUNC_MICROS[key.unit]
        body = {"field": key.column,
                "fixed_interval": f"{interval_micros // 1_000_000}s",
                "min_doc_count": 1}
        if key.unit == "week":
            # SQL DATE_TRUNC weeks are Monday-aligned; the Unix epoch is a
            # Thursday, so shift bucket boundaries back 3 days
            body["offset"] = "-3d"
        return {"date_histogram": body}
    return {"terms": {"field": key.column, "size": 65536}}


def _run_grouped(q: SqlQuery, ast, aggregates, search):
    # every selected plain column must be a group key
    group_names = {g.name for g in q.group_by} | \
                  {g.column for g in q.group_by}
    for s in q.select:
        if s.kind in ("col", "trunc") and s.name not in group_names \
                and s.column not in group_names:
            raise SqlError(f"column {s.name!r} must appear in GROUP BY")

    # GROUP BY chain of any length compiles onto one nested bucket tree
    # (arbitrary-depth flattened device bucket spaces); metrics ride the
    # innermost level
    bodies = [_group_agg_body(g) for g in q.group_by]
    bodies[-1]["aggs"] = dict(_agg_requests(aggregates))
    for i in range(len(bodies) - 2, -1, -1):
        bodies[i]["aggs"] = {f"g{i + 1}": bodies[i + 1]}
    response = search(q.index, ast, 0, {"g0": bodies[0]})

    rows: list[list] = []

    def walk(level: int, path: list[dict], container: dict) -> None:
        for bucket in container.get(f"g{level}", {}).get("buckets", []):
            if level + 1 < len(q.group_by):
                walk(level + 1, path + [bucket], bucket)
            else:
                rows.append(_bucket_row(q, path + [bucket], aggregates))

    walk(0, [], response.aggregations or {})
    rows = _apply_having(q, rows)
    rows = _order_and_limit(q, rows)
    return {"columns": [s.name for s in q.select], "rows": rows}


_HAVING_OPS = {
    "=": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b, "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b, ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _apply_having(q: SqlQuery, rows: list[list]) -> list[list]:
    if not q.having:
        return rows
    names = [s.name for s in q.select]
    for target, _op, _value in q.having:
        if target not in names:
            raise SqlError(
                f"HAVING target {target!r} must be selected (add it to "
                "the SELECT list, aliased if needed)")
    out = []
    for row in rows:
        keep = True
        for target, op, value in q.having:
            cell = row[names.index(target)]
            try:
                numeric = float(cell) if cell is not None else None
            except (TypeError, ValueError):
                raise SqlError(
                    f"HAVING target {target!r} is not numeric "
                    f"(got {cell!r})")
            if numeric is None or not _HAVING_OPS[op](numeric, value):
                keep = False
                break
        if keep:
            out.append(row)
    return out


def _bucket_key(item: SelectItem, bucket: dict):
    if item.kind == "trunc":
        return bucket.get("key_as_string", bucket.get("key"))
    return bucket.get("key")


def _bucket_row(q: SqlQuery, buckets: list[dict], aggregates):
    inner = buckets[-1]
    row = []
    for s in q.select:
        if s.kind in ("col", "trunc"):
            level = next(i for i, g in enumerate(q.group_by)
                         if g.column == s.column and g.kind == s.kind)
            row.append(_bucket_key(s, buckets[level]))
        elif s.kind == "count_star":
            row.append(inner.get("doc_count"))
        else:
            row.append(_metric_value(
                s, inner.get(_agg_key(aggregates, s), {})))
    return row


def _order_and_limit(q: SqlQuery, rows: list[list]):
    if q.order_by is not None:
        name, desc = q.order_by
        try:
            idx = [s.name for s in q.select].index(name)
        except ValueError:
            raise SqlError(f"ORDER BY target {name!r} is not selected")
        rows.sort(key=lambda r: (r[idx] is None,
                                 r[idx] if r[idx] is not None else 0),
                  reverse=desc)
    if q.offset:
        rows = rows[q.offset:]
    if q.limit is not None:
        rows = rows[: q.limit]
    return rows


def _run_projection(q: SqlQuery, ast, search):
    if q.having:
        raise SqlError("HAVING requires GROUP BY or aggregates")
    limit = q.limit if q.limit is not None else 100
    # fetch offset+limit hits so pagination slices real rows
    response = search(q.index, ast, limit + q.offset, None)
    columns = [s.name for s in q.select]
    rows = []
    for hit in response.hits:
        doc = hit.doc
        rows.append([_doc_get(doc, s.column or "") for s in q.select])
    if q.order_by:
        rows = _order_and_limit(q, rows)
    else:
        rows = rows[q.offset: q.offset + limit]
    return {"columns": columns, "rows": rows}


# --------------------------------------------------------------------------
# host-side relational layer: window functions + JOINs over rows
# materialized through the distributed search path (cap MATERIALIZE_CAP).
# The reference's DataFusion service gets these from its SQL engine over
# Parquet scans; here the device path stays the scan+filter substrate
# and the relational tail runs on the (already small) materialized set.

def _doc_get(doc, path: str):
    value: Any = doc
    for part in path.split("."):
        value = value.get(part) if isinstance(value, dict) else None
    return value


def _materialize(index: str, ast, search) -> list[dict]:
    response = search(index, ast, MATERIALIZE_CAP, None)
    if response.num_hits > MATERIALIZE_CAP:
        raise SqlError(
            f"query side matches {response.num_hits} rows; JOIN/window "
            f"materialization is capped at {MATERIALIZE_CAP} — narrow "
            "the predicate")
    return [hit.doc for hit in response.hits]


def _numeric(value) -> Optional[float]:
    if isinstance(value, bool) or value is None:
        return None
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _host_agg(func: str, column: Optional[str], values: list) -> Any:
    """One aggregate over host rows (the join/window tail). `values` are
    the raw column values (or row placeholders for COUNT(*))."""
    if func == "count" and column is None:
        return len(values)
    present = [v for v in values if v is not None]
    if func == "count":
        return len(present)
    if func == "count_distinct":
        return len({_sql_str(v) for v in present})
    nums = [n for n in (_numeric(v) for v in present) if n is not None]
    if not nums:
        return None
    if func == "sum":
        return sum(nums)
    if func == "avg":
        return sum(nums) / len(nums)
    if func == "min":
        return min(nums)
    if func == "max":
        return max(nums)
    raise SqlError(f"{func} is not supported over joined rows")


def _run_window(q: SqlQuery, ast, search):
    if q.having:
        raise SqlError("HAVING requires GROUP BY or aggregates")
    docs = _materialize(q.index, ast, search)
    win_values: dict[int, list] = {}
    for sel_idx, item in enumerate(q.select):
        if item.kind != "window":
            continue
        win_values[sel_idx] = _window_column(item, docs)
    rows = []
    for i, doc in enumerate(docs):
        row = []
        for sel_idx, item in enumerate(q.select):
            if item.kind == "window":
                row.append(win_values[sel_idx][i])
            else:
                row.append(_doc_get(doc, item.column or ""))
        rows.append(row)
    if q.order_by:
        rows = _order_and_limit(q, rows)
    else:
        limit = q.limit if q.limit is not None else 100
        rows = rows[q.offset: q.offset + limit]
    return {"columns": [s.name for s in q.select], "rows": rows}


def _window_column(item: SelectItem, docs: list[dict]) -> list:
    """Evaluate one window item over every row. With ORDER BY the frame
    is the SQL default RANGE UNBOUNDED PRECEDING..CURRENT ROW (running
    aggregate, order-value peers included); without it, the whole
    partition."""
    partitions: dict[tuple, list[int]] = {}
    for i, doc in enumerate(docs):
        key = tuple(_sql_str(_doc_get(doc, c)) for c in item.partition)
        partitions.setdefault(key, []).append(i)
    out: list = [None] * len(docs)
    for indices in partitions.values():
        if item.win_order is not None:
            col, desc = item.win_order
            order_vals = {i: _doc_get(docs[i], col) for i in indices}
            sort_key = lambda i: (  # noqa: E731
                order_vals[i] is None,
                _numeric(order_vals[i])
                if _numeric(order_vals[i]) is not None
                else 0.0,
                _sql_str(order_vals[i]) if order_vals[i] is not None
                and _numeric(order_vals[i]) is None else "")
            ordered = sorted(indices, key=sort_key, reverse=desc)
        else:
            ordered = list(indices)
        if item.func == "row_number":
            for pos, i in enumerate(ordered):
                out[i] = pos + 1
            continue
        if item.func == "rank":
            if item.win_order is None:
                for i in ordered:
                    out[i] = 1
                continue
            col, _ = item.win_order
            rank = 0
            prev = object()
            for pos, i in enumerate(ordered):
                cur = _doc_get(docs[i], col)
                if cur != prev:
                    rank = pos + 1
                    prev = cur
                out[i] = rank
            continue
        # running / whole-partition aggregate
        if item.win_order is None:
            values = [True if item.column is None
                      else _doc_get(docs[i], item.column)
                      for i in ordered]
            result = _host_agg(item.func, item.column, values)
            for i in ordered:
                out[i] = result
            continue
        col, _ = item.win_order
        # running accumulators carried across peer groups: O(n) per
        # partition (re-aggregating ordered[:end] per group is O(n^2),
        # minutes of host time at the materialization cap)
        run = _RunningAgg(item.func, item.column is None)
        pos = 0
        while pos < len(ordered):
            # peers (same order value) share one frame end
            end = pos + 1
            cur = _doc_get(docs[ordered[pos]], col)
            while end < len(ordered) \
                    and _doc_get(docs[ordered[end]], col) == cur:
                end += 1
            for i in ordered[pos:end]:
                run.add(True if item.column is None
                        else _doc_get(docs[i], item.column))
            result = run.result()
            for i in ordered[pos:end]:
                out[i] = result
            pos = end
    return out


class _RunningAgg:
    """Incremental count/sum/avg/min/max over a growing frame."""

    def __init__(self, func: str, count_star: bool):
        self.func = func
        self.count_star = count_star
        self.rows = 0        # COUNT(*): every row in the frame
        self.present = 0     # COUNT(col): non-null values
        self.total = 0.0
        self.nums = 0
        self.lo: Optional[float] = None
        self.hi: Optional[float] = None

    def add(self, value) -> None:
        self.rows += 1
        if value is None:
            return
        self.present += 1
        numeric = _numeric(value)
        if numeric is None:
            return
        self.nums += 1
        self.total += numeric
        self.lo = numeric if self.lo is None else min(self.lo, numeric)
        self.hi = numeric if self.hi is None else max(self.hi, numeric)

    def result(self):
        if self.func == "count":
            return self.rows if self.count_star else self.present
        if self.nums == 0:
            return None
        if self.func == "sum":
            return self.total
        if self.func == "avg":
            return self.total / self.nums
        if self.func == "min":
            return self.lo
        return self.hi


# --------------------------------------------------------------------------
# JOINs: each side's single-table predicates push down through the
# device scan path; the equality join itself hash-joins the (capped)
# materialized sides on the host, then the grouped/projected tail runs
# over joined rows.

def _conjuncts(node) -> list:
    """Flatten a pure-AND tree; anything else is one opaque conjunct."""
    if isinstance(node, Q.Bool) and not node.should \
            and not node.must_not and not node.filter:
        out: list = []
        for child in node.must:
            out.extend(_conjuncts(child))
        return out
    return [node]


def _pred_fields(node) -> set[str]:
    if isinstance(node, ColumnEq):
        return {node.left, node.right}
    if isinstance(node, SubqueryPred):
        if node.op in ("exists", "not_exists"):
            raise SqlError(
                "[NOT] EXISTS is not supported in this position "
                "(JOIN WHERE clauses or nested inside another EXISTS)")
        return {node.column}
    if isinstance(node, Q.Term):
        return {node.field}
    if isinstance(node, Q.Range):
        return {node.field}
    if isinstance(node, Q.TermSet):
        return set(node.terms_per_field)
    if isinstance(node, Q.Bool):
        fields: set[str] = set()
        for group in (node.must, node.must_not, node.should, node.filter):
            for child in group:
                fields |= _pred_fields(child)
        return fields
    if isinstance(node, (Q.MatchAll, Q.MatchNone)):
        return set()
    raise SqlError(
        f"unsupported predicate {type(node).__name__} in a JOIN query")


def _strip_alias(node, alias: str):
    """Rewrite every field `alias.col` -> `col` for the pushed-down
    single-table predicate."""
    from dataclasses import replace
    prefix = alias + "."

    def strip(name: str) -> str:
        return name[len(prefix):] if name.startswith(prefix) else name

    if isinstance(node, SubqueryPred):
        return SubqueryPred(strip(node.column), node.op, node.query)
    if isinstance(node, ColumnEq):
        return ColumnEq(strip(node.left), strip(node.right))
    if isinstance(node, (Q.Term, Q.Range)):
        return replace(node, field=strip(node.field))
    if isinstance(node, Q.TermSet):
        return Q.TermSet({strip(f): ts
                          for f, ts in node.terms_per_field.items()})
    if isinstance(node, Q.Bool):
        return Q.Bool(
            must=tuple(_strip_alias(c, alias) for c in node.must),
            must_not=tuple(_strip_alias(c, alias) for c in node.must_not),
            should=tuple(_strip_alias(c, alias) for c in node.should),
            filter=tuple(_strip_alias(c, alias) for c in node.filter),
            minimum_should_match=node.minimum_should_match)
    return node


def _qualified(name: str, aliases: dict[str, str]) -> tuple[str, str]:
    head, _, rest = name.partition(".")
    if head in aliases and rest:
        return head, rest
    raise SqlError(
        f"column {name!r} in a JOIN query must be alias-qualified "
        f"(one of {sorted(aliases)})")


def _row_get(row: dict[str, Optional[dict]], name: str,
             aliases: dict[str, str]):
    alias, path = _qualified(name, aliases)
    doc = row.get(alias)
    return _doc_get(doc, path) if doc is not None else None


def _run_join(q: SqlQuery, search) -> dict[str, Any]:
    aliases: dict[str, str] = {}
    if q.alias is None:
        raise SqlError("JOIN requires table aliases")
    aliases[q.alias] = q.index
    for j in q.joins:
        if j.alias in aliases:
            raise SqlError(f"duplicate table alias {j.alias!r}")
        aliases[j.alias] = j.index
    for s in q.select + q.group_by:
        if s.kind == "window":
            raise SqlError(
                "window functions are not supported in JOIN queries")
        if s.kind == "trunc":
            raise SqlError("DATE_TRUNC is not supported in JOIN queries")

    # decompose WHERE into single-table pushdowns
    pushdown: dict[str, list] = {a: [] for a in aliases}
    if q.where is not None:
        for conj in _conjuncts(q.where):
            fields = _pred_fields(conj)
            owners = {_qualified(f, aliases)[0] for f in fields}
            if len(owners) != 1:
                raise SqlError(
                    "each WHERE conjunct in a JOIN query must reference "
                    f"exactly one table (got {sorted(owners) or 'none'})")
            owner = owners.pop()
            pushdown[owner].append(_strip_alias(conj, owner))
    # a WHERE predicate on the nullable side of a LEFT JOIN is
    # null-rejecting (our predicates never match a missing field), so
    # SQL's post-join WHERE degenerates the join to INNER; pushing the
    # predicate into the side's scan while staying left-outer would
    # instead RESURRECT filtered-out rows as NULL-extended ones
    joins = [JoinClause(j.index, j.alias, j.on, left_outer=False)
             if j.left_outer and pushdown[j.alias] else j
             for j in q.joins]

    sides: dict[str, list[dict]] = {}
    for alias, index in aliases.items():
        preds = [_resolve_subqueries(p, search) for p in pushdown[alias]]
        ast = Q.Bool(must=tuple(preds)) if preds else Q.MatchAll()
        sides[alias] = _materialize(index, ast, search)

    # left-fold hash joins
    rows: list[dict[str, Optional[dict]]] = [
        {q.alias: doc} for doc in sides[q.alias]]
    joined = {q.alias}
    for j in joins:
        left_keys: list[str] = []
        right_keys: list[str] = []
        for lhs, rhs in j.on:
            l_alias, _ = _qualified(lhs, aliases)
            r_alias, _ = _qualified(rhs, aliases)
            if r_alias == j.alias and l_alias in joined:
                left_keys.append(lhs)
                right_keys.append(rhs)
            elif l_alias == j.alias and r_alias in joined:
                left_keys.append(rhs)
                right_keys.append(lhs)
            else:
                raise SqlError(
                    f"ON clause for {j.alias!r} must join it to an "
                    "already-joined table")
        # SQL NULL semantics: a missing/null key component never
        # matches anything (NULL = NULL is not true) — null-keyed docs
        # are left out of the build side and probe as no-match
        def join_key(values: list) -> Optional[tuple]:
            if any(v is None for v in values):
                return None
            return tuple(_sql_str(v) for v in values)

        table: dict[tuple, list[dict]] = {}
        for doc in sides[j.alias]:
            key = join_key([_doc_get(doc, _qualified(k, aliases)[1])
                            for k in right_keys])
            if key is not None:
                table.setdefault(key, []).append(doc)
        next_rows: list[dict[str, Optional[dict]]] = []
        for row in rows:
            key = join_key([_row_get(row, k, aliases)
                            for k in left_keys])
            matches = table.get(key, []) if key is not None else []
            if matches:
                for doc in matches:
                    next_rows.append({**row, j.alias: doc})
            elif j.left_outer:
                next_rows.append({**row, j.alias: None})
            if len(next_rows) > MATERIALIZE_CAP:
                raise SqlError(
                    f"JOIN produced more than {MATERIALIZE_CAP} rows — "
                    "narrow the predicates")
        rows = next_rows
        joined.add(j.alias)

    aggregates = [s for s in q.select if s.kind in ("agg", "count_star")]
    if q.group_by:
        return _run_join_grouped(q, rows, aggregates, aliases)
    if aggregates:
        if any(s.kind == "col" for s in q.select):
            raise SqlError("non-aggregated columns require GROUP BY")
        row = [_join_agg(s, rows, aliases) for s in q.select]
        out_rows = _apply_having(q, [row])
        return {"columns": [s.name for s in q.select], "rows": out_rows}
    if q.having:
        raise SqlError("HAVING requires GROUP BY or aggregates")
    out_rows = [[_row_get(row, s.column or "", aliases)
                 for s in q.select] for row in rows]
    if q.order_by:
        out_rows = _order_and_limit(q, out_rows)
    else:
        limit = q.limit if q.limit is not None else 100
        out_rows = out_rows[q.offset: q.offset + limit]
    return {"columns": [s.name for s in q.select], "rows": out_rows}


def _join_agg(item: SelectItem, rows: list[dict],
              aliases: dict[str, str]):
    if item.kind == "count_star":
        return len(rows)
    if item.func in ("approx_percentile", "stddev", "variance"):
        raise SqlError(f"{item.func} is not supported over joined rows")
    values = [_row_get(row, item.column or "", aliases) for row in rows]
    return _host_agg(item.func, item.column, values)


def _run_join_grouped(q: SqlQuery, rows: list[dict], aggregates,
                      aliases: dict[str, str]) -> dict[str, Any]:
    keys = [g.column or "" for g in q.group_by]
    group_names = {g.name for g in q.group_by} | set(keys)
    for s in q.select:
        if s.kind == "col" and s.name not in group_names \
                and s.column not in group_names:
            raise SqlError(f"column {s.name!r} must appear in GROUP BY")
    groups: dict[tuple, list[dict]] = {}
    for row in rows:
        key = tuple(_row_get(row, k, aliases) for k in keys)
        groups.setdefault(key, []).append(row)
    out_rows = []
    for key, members in groups.items():
        out = []
        for s in q.select:
            if s.kind == "col":
                out.append(key[keys.index(s.column or "")])
            else:
                out.append(_join_agg(s, members, aliases))
        out_rows.append(out)
    out_rows = _apply_having(q, out_rows)
    out_rows = _order_and_limit(q, out_rows)
    return {"columns": [s.name for s in q.select], "rows": out_rows}
