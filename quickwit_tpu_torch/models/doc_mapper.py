"""Doc mapping: JSON documents → typed docs, and the schema they obey.

Role of the reference's `quickwit-doc-mapper` (`doc_mapper_impl.rs`,
`mapping_tree.rs`, `field_mapping_entry.rs`): the per-index schema that
 - validates and types incoming JSON documents,
 - declares which fields are indexed (inverted), fast (columnar), stored,
 - names the timestamp field used for split pruning,
 - declares tag fields and default search fields,
 - is the context against which a QueryAst is lowered.

TPU-first divergence: fields are a *flat* list of dot-separated paths (the
reference flattens its mapping tree the same way at tantivy-schema build
time), and fast fields are laid out as dense HBM-friendly columns
(see `index/columns.py`).

Dynamic mode (`mode: dynamic` + `dynamic_mapping`, reference:
`field_mapping_entry.rs:613` QuickwitJsonOptions::default_dynamic): every
unmapped leaf path materializes per split as a raw-tokenized text field
whose terms carry the canonical string form of the JSON value — the
analogue of tantivy's path-prefixed JSON terms, on this engine's padded
posting arrays. Term/full-text/phrase queries on unmapped paths resolve
against these per-split fields at plan time. Fast columns for dynamic
paths are not materialized yet (range/sort/agg on a dynamic path needs a
concrete mapping; the config's `fast` flag is accepted for compatibility).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import Any, Iterator, Optional, Sequence

from ..query.tokenizers import get_tokenizer
from ..utils.datetime_utils import parse_datetime_to_micros


class DocParsingError(ValueError):
    pass


class FieldType(str, Enum):
    TEXT = "text"
    I64 = "i64"
    U64 = "u64"
    F64 = "f64"
    BOOL = "bool"
    DATETIME = "datetime"
    IP = "ip"
    BYTES = "bytes"
    JSON = "json"


@dataclass(frozen=True)
class FieldMapping:
    """One field of the schema (reference: `FieldMappingEntry`)."""
    name: str  # dot-separated path, e.g. "resource.service"
    type: FieldType
    tokenizer: str = "default"      # for TEXT
    record: str = "basic"           # "basic" (doc,tf) | "position" (phrase-capable)
    indexed: bool = True
    fast: bool = False
    stored: bool = True
    input_formats: tuple[str, ...] = ("rfc3339", "unix_timestamp")  # DATETIME
    output_format: str = "rfc3339"
    # normalizer applied to TEXT fast-column values (reference:
    # `fast: {normalizer: lowercase}` — terms aggs and fast-field reads
    # observe the normalized form)
    normalizer: Optional[str] = None
    # DATETIME fast-column precision (reference `fast_precision`):
    # "seconds" | "milliseconds" | None (microseconds). Stored values AND
    # range bounds truncate to it, so sub-precision bounds behave like ES.
    fast_precision: Optional[str] = None
    # `type: concatenate` (reference: field_mapping_entry.rs concatenate
    # fields): a synthetic TEXT field indexing the canonical leaf values
    # of the listed source fields (and, optionally, of every dynamic
    # leaf) under ITS OWN tokenizer. Internally typed TEXT; non-empty
    # concatenate_fields marks it.
    concatenate_fields: tuple[str, ...] = ()
    include_dynamic_fields: bool = False

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "type": ("concatenate" if self.concatenate_fields
                     else self.type.value),
            "tokenizer": self.tokenizer,
            "record": self.record, "indexed": self.indexed, "fast": self.fast,
            "stored": self.stored, "input_formats": list(self.input_formats),
            "output_format": self.output_format, "normalizer": self.normalizer,
            "fast_precision": self.fast_precision,
            "concatenate_fields": list(self.concatenate_fields),
            "include_dynamic_fields": self.include_dynamic_fields,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "FieldMapping":
        fast = d.get("fast", False)
        normalizer = d.get("normalizer")
        if isinstance(fast, dict):
            # reference shape: `fast: {normalizer: lowercase}`
            normalizer = fast.get("normalizer", normalizer)
            fast = True
        type_name = d["type"]
        concatenate_fields = tuple(d.get("concatenate_fields", ()))
        if type_name == "concatenate":
            type_name = "text"
            if not concatenate_fields:
                raise ValueError(
                    f"concatenate field {d['name']!r} needs concatenate_fields")
        return FieldMapping(
            name=d["name"], type=FieldType(type_name),
            tokenizer=d.get("tokenizer", "default"), record=d.get("record", "basic"),
            indexed=d.get("indexed", True), fast=fast,
            stored=d.get("stored", True),
            input_formats=tuple(d.get("input_formats", ("rfc3339", "unix_timestamp"))),
            output_format=d.get("output_format", "rfc3339"),
            normalizer=normalizer,
            fast_precision=d.get("fast_precision"),
            concatenate_fields=concatenate_fields,
            include_dynamic_fields=d.get("include_dynamic_fields", False),
        )


@dataclass(frozen=True)
class DynamicMapping:
    """Indexing options applied to unmapped fields under `mode: dynamic`
    (reference: QuickwitJsonOptions, `field_mapping_entry.rs:621`)."""
    indexed: bool = True
    tokenizer: str = "raw"     # reference default_json: raw, no fieldnorms
    record: str = "basic"
    stored: bool = True
    fast: bool = True          # per-split typed dynamic columns
    expand_dots: bool = True

    def to_dict(self) -> dict[str, Any]:
        return {"indexed": self.indexed, "tokenizer": self.tokenizer,
                "record": self.record, "stored": self.stored,
                "fast": self.fast, "expand_dots": self.expand_dots}

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "DynamicMapping":
        fast = d.get("fast", True)
        if isinstance(fast, dict):
            fast = True
        return DynamicMapping(
            indexed=d.get("indexed", True),
            tokenizer=d.get("tokenizer", "raw"),
            record=d.get("record", "basic"),
            stored=d.get("stored", True), fast=fast,
            expand_dots=d.get("expand_dots", True))


def _iter_path(doc: Any, path: Sequence[str]) -> Iterator[Any]:
    """Yield all values at `path` in a (possibly nested/array) JSON doc."""
    if not path:
        if isinstance(doc, list):
            yield from doc
        elif doc is not None:
            yield doc
        return
    if isinstance(doc, list):
        for item in doc:
            yield from _iter_path(item, path)
    elif isinstance(doc, dict):
        key = path[0]
        if key in doc:
            yield from _iter_path(doc[key], path[1:])


@dataclass
class TypedDoc:
    """A validated document: per-field typed values + the raw source."""
    fields: dict[str, list[Any]]
    source: dict[str, Any]

    def timestamp_micros(self, timestamp_field: Optional[str]) -> Optional[int]:
        if timestamp_field is None:
            return None
        values = self.fields.get(timestamp_field)
        return values[0] if values else None


@dataclass
class DocMapper:
    """Schema + conversion + (via search/plan.py) query lowering context.

    Reference parity: `DocMapper::doc_from_json` → `validate/convert`;
    `DocMapper::query` is implemented in `search/plan.py::lower_ast` against
    this object.
    """
    doc_mapping_uid: str = "default"
    field_mappings: list[FieldMapping] = dc_field(default_factory=list)
    timestamp_field: Optional[str] = None
    tag_fields: tuple[str, ...] = ()
    default_search_fields: tuple[str, ...] = ()
    store_source: bool = True
    # "lenient" (unknown fields ignored) | "strict" (rejected) |
    # "dynamic" (materialized per dynamic_mapping)
    mode: str = "lenient"
    dynamic_mapping: Optional[DynamicMapping] = None
    # doc-level partition routing (reference: `routing_expression/mod.rs`,
    # doc_mapping.partition_key + max_num_partitions): docs hash to
    # partitions, each split holds one partition, only same-partition
    # splits merge
    partition_key: str = ""
    max_num_partitions: int = 200
    # reference `store_document_size`: a synthetic `_doc_length` fast
    # column holding each doc's serialized byte size (aggregatable,
    # never part of _source)
    store_document_size: bool = False

    def __post_init__(self) -> None:
        self._by_name = {fm.name: fm for fm in self.field_mappings}
        self._concat_fields = [fm for fm in self.field_mappings
                               if fm.concatenate_fields]
        # interior dotted prefixes of mapped names ("a.b.c" → {"a","a.b"}):
        # O(1) membership test on the per-doc dynamic walk
        self._interior_prefixes = set()
        for fm in self.field_mappings:
            parts = fm.name.split(".")
            for i in range(1, len(parts)):
                self._interior_prefixes.add(".".join(parts[:i]))
        if self.mode == "dynamic" and self.dynamic_mapping is None:
            self.dynamic_mapping = DynamicMapping()
        from .routing_expression import RoutingExpr
        self._routing_expr = RoutingExpr(self.partition_key)
        if self.timestamp_field is not None:
            ts = self._by_name.get(self.timestamp_field)
            if ts is None or ts.type is not FieldType.DATETIME or not ts.fast:
                raise ValueError(
                    f"timestamp_field {self.timestamp_field!r} must be a fast datetime field")

    def field(self, name: str) -> Optional[FieldMapping]:
        return self._by_name.get(name)

    def dynamic_field(self, name: str) -> FieldMapping:
        """The synthesized mapping an unmapped path gets under
        `mode: dynamic` — raw-tokenized text over canonical value strings
        (both the writer and the query lowering use this, so index- and
        query-side terms always agree). `fast` carries the dynamic
        mapping's flag: the writer materializes a per-split typed column
        (string→ordinal, int→i64, float→f64, bool→bool) behind it."""
        dm = self.dynamic_mapping or DynamicMapping()
        return FieldMapping(name, FieldType.TEXT, tokenizer=dm.tokenizer,
                            record=dm.record, indexed=dm.indexed,
                            stored=dm.stored, fast=dm.fast)

    def shadows_concrete_field(self, name: str) -> bool:
        """True when a dotted path descends through a mapped NON-JSON
        field (`text.inner` under a concrete text field): such paths are
        never dynamic — they are simply invalid."""
        parts = name.split(".")
        for i in range(1, len(parts)):
            parent = self._by_name.get(".".join(parts[:i]))
            if parent is not None:
                return parent.type is not FieldType.JSON
        return False

    @property
    def fast_fields(self) -> list[FieldMapping]:
        return [fm for fm in self.field_mappings if fm.fast]

    @property
    def indexed_fields(self) -> list[FieldMapping]:
        return [fm for fm in self.field_mappings if fm.indexed]

    # ------------------------------------------------------------------
    def doc_from_json(self, doc: dict[str, Any]) -> TypedDoc:
        if not isinstance(doc, dict):
            raise DocParsingError(f"document must be a JSON object, got {type(doc).__name__}")
        fields: dict[str, list[Any]] = {}
        for fm in self.field_mappings:
            if fm.concatenate_fields:
                continue  # synthesized below from the source fields
            raw_values = list(_iter_path(doc, fm.name.split(".")))
            if not raw_values:
                continue
            try:
                fields[fm.name] = [self._convert(fm, v) for v in raw_values]
            except (ValueError, TypeError) as exc:
                raise DocParsingError(f"field {fm.name!r}: {exc}") from exc
        if self.mode == "strict":
            known_roots = {fm.name.split(".")[0] for fm in self.field_mappings}
            for key in doc:
                if key not in known_roots:
                    raise DocParsingError(f"unknown field {key!r} in strict mapping")
        elif self.mode == "dynamic":
            self._collect_dynamic(doc, (), fields)
        if self.timestamp_field is not None and self.timestamp_field not in fields:
            # reference parity (doc_processor.rs): every doc must carry the
            # timestamp field — split time ranges then bound ALL docs, which
            # the time-pruning and metadata-count paths rely on
            raise DocParsingError(
                f"document is missing timestamp field {self.timestamp_field!r}")
        for cf in self._concat_fields:
            values = self._concat_values(cf, fields)
            if values:
                fields[cf.name] = values
        return TypedDoc(fields=fields, source=doc if self.store_source else {})

    def _concat_values(self, cf: FieldMapping,
                       fields: dict[str, list[Any]]) -> list[str]:
        """Canonical leaf-value strings a concatenate field indexes: the
        listed source fields' values (JSON fields contribute every leaf)
        plus, with include_dynamic_fields, every dynamic leaf value."""
        out: list[str] = []

        def leaves(value: Any) -> None:
            if isinstance(value, dict):
                for v in value.values():
                    leaves(v)
            elif isinstance(value, list):
                for v in value:
                    leaves(v)
            elif value is not None:
                out.append(dynamic_canonical(value))

        for src in cf.concatenate_fields:
            for value in fields.get(src, ()):
                leaves(value)
        if cf.include_dynamic_fields:
            for name, values in fields.items():
                if name not in self._by_name:  # dynamic leaf
                    for value in values:
                        leaves(value)
        return out

    def _collect_dynamic(self, node: Any, path: tuple[str, ...],
                         fields: dict[str, list[Any]]) -> None:
        """Walk the doc's UNMAPPED parts, materializing each leaf value
        under its dotted path as a canonical string (numbers/bools index
        the same string the query lowering produces)."""
        if isinstance(node, dict):
            for key, value in node.items():
                sub = path + (key,)
                dotted = ".".join(sub)
                fm = self._by_name.get(dotted)
                if fm is not None:
                    if fm.type is FieldType.JSON:
                        # subpaths of a mapped JSON field stay searchable
                        # in dynamic mode via dynamic leaves (the whole
                        # value is separately stored under the mapping)
                        self._collect_dynamic_leaves(value, sub, fields)
                    elif "." in key and not fields.get(dotted):
                        # literal dotted key colliding with a mapped name
                        # (expand_dots): route it to the concrete mapping
                        # instead of silently dropping it
                        raw = value if isinstance(value, list) else [value]
                        try:
                            fields[dotted] = [self._convert(fm, v)
                                              for v in raw if v is not None]
                        except (ValueError, TypeError) as exc:
                            raise DocParsingError(
                                f"field {dotted!r}: {exc}") from exc
                    continue
                if dotted in self._interior_prefixes:
                    # interior node of the concrete schema: only its
                    # unmapped children are dynamic
                    self._collect_dynamic(value, sub, fields)
                else:
                    self._collect_dynamic_leaves(value, sub, fields)
        elif isinstance(node, list):
            for item in node:
                self._collect_dynamic(item, path, fields)

    def _collect_dynamic_leaves(self, node: Any, path: tuple[str, ...],
                                fields: dict[str, list[Any]]) -> None:
        """Collect RAW leaf values (bool/int/float/str) under dotted
        paths. The writer types each dynamic leaf per split from these
        (long/double/boolean/string value classes — reference: tantivy's
        typed JSON terms + dynamic columns); term lowering uses the
        canonical string form (`dynamic_canonical`)."""
        if node is None:
            return
        if isinstance(node, dict):
            for key, value in node.items():
                self._collect_dynamic_leaves(value, path + (key,), fields)
            return
        if isinstance(node, list):
            for item in node:
                self._collect_dynamic_leaves(item, path, fields)
            return
        fields.setdefault(".".join(path), []).append(node)

    def _convert(self, fm: FieldMapping, value: Any) -> Any:
        t = fm.type
        if t is FieldType.TEXT:
            if not isinstance(value, str):
                value = str(value)
            return value
        if t is FieldType.I64:
            if isinstance(value, bool) or not isinstance(value, (int, float, str)):
                raise ValueError(f"expected i64, got {value!r}")
            return int(value)
        if t is FieldType.U64:
            if isinstance(value, bool):
                raise ValueError(f"expected u64, got {value!r}")
            iv = int(value)
            if iv < 0:
                raise ValueError(f"expected u64, got {value!r}")
            return iv
        if t is FieldType.F64:
            if isinstance(value, bool):
                raise ValueError(f"expected f64, got {value!r}")
            return float(value)
        if t is FieldType.BOOL:
            if isinstance(value, bool):
                return value
            if isinstance(value, str) and value.lower() in ("true", "false"):
                return value.lower() == "true"
            raise ValueError(f"expected bool, got {value!r}")
        if t is FieldType.DATETIME:
            return parse_datetime_to_micros(value, fm.input_formats)
        if t is FieldType.IP:
            import ipaddress
            return int(ipaddress.ip_address(value))
        if t is FieldType.BYTES:
            import base64
            if isinstance(value, str):
                return base64.b64decode(value)
            raise ValueError(f"expected base64 string, got {value!r}")
        if t is FieldType.JSON:
            return value
        raise ValueError(f"unhandled field type {t}")

    # ------------------------------------------------------------------
    def tokens_for_field(self, fm: FieldMapping, value: Any) -> list:
        """Index tokens for one value of one field."""
        if fm.type is FieldType.TEXT:
            return get_tokenizer(fm.tokenizer)(value)
        # non-text indexed fields index their canonical string form as a raw term
        from ..query.tokenizers import Token
        return [Token(canonical_term(fm, value), 0)]

    def partition_id(self, doc: dict[str, Any]) -> int:
        """Stable u64 partition for a raw JSON doc (0 = unpartitioned)."""
        return self._routing_expr.eval_hash(doc)

    def tags(self, tdoc: TypedDoc) -> set[str]:
        """`tag_field:value` strings recorded in split metadata for pruning
        (reference: `tag_pruning.rs`)."""
        out: set[str] = set()
        for tag_field in self.tag_fields:
            for v in tdoc.fields.get(tag_field, []):
                out.add(f"{tag_field}:{v}")
        return out

    # ------------------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return {
            "doc_mapping_uid": self.doc_mapping_uid,
            "field_mappings": [fm.to_dict() for fm in self.field_mappings],
            "timestamp_field": self.timestamp_field,
            "tag_fields": list(self.tag_fields),
            "default_search_fields": list(self.default_search_fields),
            "store_source": self.store_source,
            "mode": self.mode,
            "dynamic_mapping": (self.dynamic_mapping.to_dict()
                                if self.dynamic_mapping else None),
            "partition_key": self.partition_key,
            "max_num_partitions": self.max_num_partitions,
            "store_document_size": self.store_document_size,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "DocMapper":
        if not isinstance(d, dict):
            raise ValueError(
                f"doc_mapping must be a JSON object, "
                f"got {type(d).__name__}")
        if not isinstance(d.get("field_mappings", []), list):
            raise ValueError("field_mappings must be a list")
        for key in ("tag_fields", "default_search_fields"):
            value = d.get(key, [])
            if not isinstance(value, (list, tuple)) or not all(
                    isinstance(f, str) for f in value):
                raise ValueError(f"{key} must be a list of strings")
        if d.get("dynamic_mapping") is not None \
                and not isinstance(d["dynamic_mapping"], dict):
            raise ValueError("dynamic_mapping must be a JSON object")
        return DocMapper(
            doc_mapping_uid=d.get("doc_mapping_uid", "default"),
            field_mappings=_expand_field_mappings(d.get("field_mappings", [])),
            timestamp_field=d.get("timestamp_field"),
            tag_fields=tuple(d.get("tag_fields", ())),
            default_search_fields=tuple(d.get("default_search_fields", ())),
            store_source=d.get("store_source", True),
            mode=d.get("mode", "lenient"),
            dynamic_mapping=(DynamicMapping.from_dict(d["dynamic_mapping"])
                             if d.get("dynamic_mapping") else None),
            partition_key=d.get("partition_key", ""),
            max_num_partitions=d.get("max_num_partitions", 200),
            store_document_size=d.get("store_document_size", False),
        )


def _expand_field_mappings(entries: Sequence[dict],
                           prefix: str = "") -> list[FieldMapping]:
    """Parse field-mapping entries, flattening `type: object` groups into
    dotted paths (reference: `mapping_tree.rs` builds the same flat
    tantivy schema from its nested tree) and accepting the `array<T>`
    aliases (every field is multivalued in this engine, so array<T> ≡ T)."""
    out: list[FieldMapping] = []
    for d in entries:
        if not isinstance(d, dict):
            raise ValueError(
                f"field mapping entry must be an object, got {d!r}")
        if not isinstance(d.get("name"), str) or not d["name"]:
            raise ValueError(
                f"field mapping entry requires a string name "
                f"(got {d.get('name')!r})")
        typ = str(d.get("type", "text"))
        if typ.startswith("array<") and typ.endswith(">"):
            d = {**d, "type": typ[len("array<"):-1]}
            typ = d["type"]
        name = prefix + d["name"]
        if typ == "object":
            out.extend(_expand_field_mappings(
                d.get("field_mappings", []), name + "."))
        else:
            out.append(FieldMapping.from_dict({**d, "name": name}))
    return out


def dynamic_canonical(value: Any) -> str:
    """Canonical string form of a dynamic leaf value — shared by the
    writer (index terms, ordinal column entries) and the query lowering,
    so both sides always agree."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float):
        return repr(value)
    return str(value)


def canonical_term(fm: FieldMapping, value: Any) -> str:
    """Canonical index-term string for a non-text value.

    Numeric/datetime/bool/ip values are indexed under a canonical string so
    query-side Term("field","42") matches; mirrors tantivy's typed terms.
    """
    if fm.type is FieldType.BOOL:
        return "true" if value else "false"
    if fm.type in (FieldType.I64, FieldType.U64, FieldType.DATETIME, FieldType.IP):
        return str(int(value))
    if fm.type is FieldType.F64:
        return repr(float(value))
    if fm.type is FieldType.BYTES:
        import base64
        return base64.b64encode(value).decode()
    return str(value)
