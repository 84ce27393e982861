"""The system under test: one node of `quickwit_tpu_torch` in this process,
its root reaching its search service through `LocalSearchClient` as the
node's REST handler does, over splits in RAM storage published in a
file-backed metastore."""

from __future__ import annotations

from quickwit_tpu_torch.common.uri import Protocol, Uri
from quickwit_tpu_torch.index.format import read_footer
from quickwit_tpu_torch.metastore.file_backed import FileBackedMetastore
from quickwit_tpu_torch.models.doc_mapper import DocMapper
from quickwit_tpu_torch.models.index_metadata import IndexConfig, IndexMetadata
from quickwit_tpu_torch.models.split_metadata import SplitMetadata
from quickwit_tpu_torch.query.es_dsl import es_query_to_ast
from quickwit_tpu_torch.search import service as service_mod
from quickwit_tpu_torch.search.models import SearchRequest, SortField
from quickwit_tpu_torch.search.root import RootSearcher
from quickwit_tpu_torch.storage.base import StorageResolver
from quickwit_tpu_torch.storage.ram import RamStorage

SPLITS_URI = "ram:///qwbench/splits"


class Node:
    def __init__(self, config: dict, splits: list[tuple[str, bytes, dict]],
                 device: str):
        self.index_id = config["index_id"]
        self.storage = RamStorage(Uri.parse(SPLITS_URI))
        self.footers = {}
        for split_id, data, _ in splits:
            self.storage.put(f"{split_id}.split", data)
            self.footers[split_id] = read_footer(
                lambda a, b, d=data: d[a:b], len(data))
        self.metastore = FileBackedMetastore(
            RamStorage(Uri.parse("ram:///qwbench/metastore")))
        index_uid = f"{self.index_id}:01"
        self.metastore.create_index(IndexMetadata(
            index_uid=index_uid, index_config=IndexConfig(
                index_id=self.index_id, index_uri=SPLITS_URI,
                doc_mapper=DocMapper.from_dict(config["doc_mapping"]))))
        self.metastore.stage_splits(index_uid, [SplitMetadata(
            split_id=split_id, index_uid=index_uid, source_id="qwbench",
            num_docs=facts["num_docs"], footprint_bytes=len(data),
            time_range_start=facts["time_range"][0],
            time_range_end=facts["time_range"][1],
            column_bounds=facts["column_bounds"])
            for split_id, data, facts in splits])
        self.metastore.publish_splits(index_uid,
                                      [split_id for split_id, _, _ in splits])
        resolver = StorageResolver()
        resolver.register(Protocol.RAM, lambda _uri: self.storage)
        self.context = service_mod.SearcherContext(
            storage_resolver=resolver, device=device, **config["node"])
        self.service = service_mod.SearchService(self.context,
                                                 node_id="node-0")
        self.root = RootSearcher(self.metastore, {
            "node-0": service_mod.LocalSearchClient(self.service)})

    def request(self, spec: dict, profile: bool = False) -> SearchRequest:
        """The port's request for a spec; a spec's `sort_by` (a list of
        `{"field", "order"}`) becomes its sort fields."""
        sort = {}
        if spec.get("sort_by"):
            sort["sort_fields"] = tuple(
                SortField(key["field"], key.get("order", "desc"))
                for key in spec["sort_by"])
        return SearchRequest(
            index_ids=[self.index_id],
            query_ast=es_query_to_ast(spec.get("query", {"match_all": {}})),
            max_hits=spec.get("max_hits", 20), aggs=spec.get("aggs"),
            start_timestamp=spec.get("start_timestamp"),
            end_timestamp=spec.get("end_timestamp"), profile=profile,
            **sort)

    def search(self, spec: dict, profile: bool = False):
        return self.root.search(self.request(spec, profile))
