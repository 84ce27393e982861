"""Command-line interface.

Role of the reference's `quickwit-cli` (`cli.rs:56`):

  quickwit-tpu run [--config FILE]                      start a node
  quickwit-tpu index create --index-config FILE
  quickwit-tpu index list | describe | delete --index ID
  quickwit-tpu index ingest --index ID [--input-path F] [ndjson on stdin]
  quickwit-tpu index search --index ID --query Q [--max-hits N] [--aggs JSON]
  quickwit-tpu index merge --index ID                   one merge pass
  quickwit-tpu source create --index ID --source-config FILE
  quickwit-tpu source list | delete | enable | disable --index ID [--source S]
  quickwit-tpu split list | describe | mark-for-deletion --index ID
  quickwit-tpu tool gc | retention                      janitor passes
  quickwit-tpu tool extract-split --index ID --split ID --output-dir D

Commands other than `run` execute against a running node's REST API when
`--endpoint` is given, or an embedded node otherwise (reference: CLI's
local/remote duality).

Counterpart of the JAX package's `cli.py`, run as
`python -m quickwit_tpu_torch.cli`. The node searches on the GPU unless
`QW_DEVICE` (or the config's `device`) names another device, e.g.
`QW_DEVICE=cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Optional

from .common.uri import Protocol
from .config import load_index_config, load_node_config
from .serve.node import Node, NodeConfig
from .storage.base import StorageResolver
from .storage.local import LocalFileStorage
from .storage.ram import RamStorage


def _resolver() -> StorageResolver:
    # file + ram + env-configured S3 (hedged), one shared registry
    return StorageResolver.default()


def _embedded_node(args) -> Node:
    config = load_node_config(getattr(args, "config", None))
    return Node(config, storage_resolver=_resolver())


def cmd_run(args) -> int:
    from .serve.rest import RestServer
    config = load_node_config(args.config)
    node = Node(config, storage_resolver=_resolver())
    server = RestServer(node)
    server.start()
    node.start_background_services()
    print(f"node {config.node_id} (roles: {','.join(config.roles)}) "
          f"listening on "
          f"{'https' if config.tls_enabled else 'http'}://{server.endpoint}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        node.stop_background_services()
        server.stop()
    return 0


def cmd_index_create(args) -> int:
    node = _embedded_node(args)
    index_config = load_index_config(args.index_config)
    metadata = node.index_service.create_index(index_config)
    print(json.dumps(metadata.to_dict(), indent=2))
    return 0


def cmd_index_list(args) -> int:
    node = _embedded_node(args)
    for metadata in node.metastore.list_indexes():
        print(metadata.index_id)
    return 0


def cmd_index_describe(args) -> int:
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    from .metastore.base import ListSplitsQuery
    splits = node.metastore.list_splits(
        ListSplitsQuery(index_uids=[metadata.index_uid]))
    from .models.split_metadata import SplitState
    published = [s for s in splits if s.state is SplitState.PUBLISHED]
    print(json.dumps({
        "index": metadata.to_dict(),
        "num_splits": len(published),
        "num_docs": sum(s.metadata.num_docs for s in published),
        "splits_by_state": {
            state.value: sum(1 for s in splits if s.state is state)
            for state in SplitState
            if any(s.state is state for s in splits)
        },
    }, indent=2))
    return 0


def cmd_index_delete(args) -> int:
    node = _embedded_node(args)
    removed = node.index_service.delete_index(args.index)
    print(f"deleted index {args.index} ({len(removed)} split files removed)")
    return 0


def cmd_index_ingest(args) -> int:
    node = _embedded_node(args)
    if args.input_path:
        stream = open(args.input_path, "rb")
    else:
        stream = sys.stdin.buffer
    docs = []
    total = {"num_docs_for_processing": 0, "num_ingested_docs": 0,
             "num_invalid_docs": 0}
    def flush():
        if not docs:
            return
        result = node.ingest(args.index, docs, commit="force")
        for key in total:
            total[key] += result[key]
        docs.clear()
    for line in stream:
        line = line.strip()
        if line:
            docs.append(json.loads(line))
        if len(docs) >= args.batch_size:
            flush()
    flush()
    if args.input_path:
        stream.close()
    print(json.dumps(total))
    return 0


def cmd_index_search(args) -> int:
    from .query.parser import parse_query_string
    from .search.models import SearchRequest, SortField
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    default_fields = metadata.index_config.doc_mapper.default_search_fields
    sort_fields: tuple[SortField, ...] = (SortField(),)
    if args.sort_by:
        field_name = args.sort_by.lstrip("-+")
        if args.sort_order is not None:
            order = args.sort_order
        else:
            order = "desc" if args.sort_by.startswith("-") else "asc"
        sort_fields = (SortField(field_name, order),)
    request = SearchRequest(
        index_ids=[args.index],
        query_ast=parse_query_string(args.query, default_fields),
        max_hits=args.max_hits,
        start_offset=args.start_offset,
        sort_fields=sort_fields,
        aggs=json.loads(args.aggs) if args.aggs else None,
        start_timestamp=args.start_timestamp,
        end_timestamp=args.end_timestamp,
    )
    response = node.root_searcher.search(request)
    print(json.dumps(response.to_dict(), indent=2, default=str))
    return 0


def cmd_index_merge(args) -> int:
    node = _embedded_node(args)
    num_ops = node.run_merges(args.index)
    print(f"executed {num_ops} merge operations")
    return 0


def cmd_source_create(args) -> int:
    from .config import load_source_config
    from .indexing.sources import parse_source_config
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    # same parse/validation path as the REST POST /sources route
    source = parse_source_config(load_source_config(args.source_config))
    node.metastore.add_source(metadata.index_uid, source)
    print(json.dumps(source.to_dict(), indent=2))
    return 0


def cmd_source_list(args) -> int:
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    print(json.dumps({"sources": [s.to_dict()
                                  for s in metadata.sources.values()]},
                     indent=2))
    return 0


def cmd_source_delete(args) -> int:
    from .ingest.router import INTERNAL_SOURCE_IDS
    if args.source in INTERNAL_SOURCE_IDS:
        print(f"error: {args.source} is a built-in source",
              file=sys.stderr)
        return 1
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    node.metastore.delete_source(metadata.index_uid, args.source)
    print(f"deleted source {args.source}")
    return 0


def cmd_source_reset_checkpoint(args) -> int:
    from .ingest.router import INTERNAL_SOURCE_IDS
    if args.source in INTERNAL_SOURCE_IDS:
        print(f"error: {args.source} is a built-in source; its "
              "checkpoint guards the ingest WAL against replay",
              file=sys.stderr)
        return 1
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    node.metastore.reset_source_checkpoint(metadata.index_uid,
                                           args.source)
    print(f"reset checkpoint of source {args.source} "
          "(the source replays from the beginning)")
    return 0


def cmd_source_toggle(args) -> int:
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    enable = args.subcommand == "enable"
    node.metastore.toggle_source(metadata.index_uid, args.source, enable)
    print(f"{'enabled' if enable else 'disabled'} source {args.source}")
    return 0


def cmd_split_describe(args) -> int:
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    from .metastore.base import ListSplitsQuery
    splits = node.metastore.list_splits(
        ListSplitsQuery(index_uids=[metadata.index_uid]))
    for split in splits:
        if split.metadata.split_id == args.split:
            print(json.dumps(split.to_dict(), indent=2))
            return 0
    print(f"error: split {args.split} not found in {args.index}",
          file=sys.stderr)
    return 1


def cmd_split_mark_for_deletion(args) -> int:
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    split_ids = [s.strip() for s in args.splits.split(",") if s.strip()]
    if not split_ids:
        print("error: --splits parsed to no split ids", file=sys.stderr)
        return 1
    from .metastore.base import ListSplitsQuery
    known = {s.metadata.split_id for s in node.metastore.list_splits(
        ListSplitsQuery(index_uids=[metadata.index_uid]))}
    unknown = [s for s in split_ids if s not in known]
    if unknown:
        # the metastore skips unknown ids silently; the CLI must not
        # report success for splits that were never marked
        print(f"error: unknown split id(s): {', '.join(unknown)}",
              file=sys.stderr)
        return 1
    node.metastore.mark_splits_for_deletion(metadata.index_uid, split_ids)
    print(f"marked {len(split_ids)} split(s) for deletion "
          "(the janitor GC pass removes the files)")
    return 0


def cmd_split_list(args) -> int:
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    from .metastore.base import ListSplitsQuery
    splits = node.metastore.list_splits(
        ListSplitsQuery(index_uids=[metadata.index_uid]))
    print(json.dumps({"splits": [s.to_dict() for s in splits]}, indent=2))
    return 0


def cmd_tool_gc(args) -> int:
    node = _embedded_node(args)
    print(json.dumps(node.run_janitor()))
    return 0


def cmd_tool_extract_split(args) -> int:
    import os
    node = _embedded_node(args)
    metadata = node.metastore.index_metadata(args.index)
    storage = node.storage_resolver.resolve(metadata.index_config.index_uri)
    os.makedirs(args.output_dir, exist_ok=True)
    dest = os.path.join(args.output_dir, f"{args.split}.split")
    storage.copy_to_file(f"{args.split}.split", dest)
    print(f"extracted to {dest}")
    return 0


def cmd_trace_export(args) -> int:
    """Export the flight recorder as Chrome trace-event / Perfetto JSON —
    from a running node's `/api/v1/developer/trace` endpoint when
    `--endpoint` is given, else from this process's own recorder (useful
    after an in-process repro or bench run)."""
    if args.endpoint:
        import urllib.request
        base = (args.endpoint if "://" in args.endpoint
                else f"http://{args.endpoint}")
        url = base.rstrip("/") + "/api/v1/developer/trace"
        if args.limit:
            url += f"?limit={int(args.limit)}"
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            trace = json.loads(resp.read().decode("utf-8"))
    else:
        from .observability.flight import FLIGHT
        trace = FLIGHT.to_chrome_trace(limit=args.limit or None)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(trace, f)
        f.write("\n")
    events = len(trace.get("traceEvents", []))
    print(f"wrote {events} trace events to {args.out} "
          f"(load in Perfetto / chrome://tracing)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="quickwit-tpu",
        description="distributed search engine (PyTorch/CUDA port)")
    parser.add_argument("--config", help="node config yaml", default=None)
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="start a node")
    run.set_defaults(func=cmd_run)

    index = sub.add_parser("index", help="index management")
    index_sub = index.add_subparsers(dest="subcommand", required=True)
    create = index_sub.add_parser("create")
    create.add_argument("--index-config", required=True)
    create.set_defaults(func=cmd_index_create)
    lst = index_sub.add_parser("list")
    lst.set_defaults(func=cmd_index_list)
    describe = index_sub.add_parser("describe")
    describe.add_argument("--index", required=True)
    describe.set_defaults(func=cmd_index_describe)
    delete = index_sub.add_parser("delete")
    delete.add_argument("--index", required=True)
    delete.set_defaults(func=cmd_index_delete)
    ingest = index_sub.add_parser("ingest")
    ingest.add_argument("--index", required=True)
    ingest.add_argument("--input-path", default=None)
    ingest.add_argument("--batch-size", type=int, default=100_000)
    ingest.set_defaults(func=cmd_index_ingest)
    search = index_sub.add_parser("search")
    search.add_argument("--index", required=True)
    search.add_argument("--query", required=True)
    search.add_argument("--max-hits", type=int, default=20)
    search.add_argument("--start-offset", type=int, default=0)
    # `--sort-by=-field` for descending (leading dash needs the `=` form,
    # or use --sort-order)
    search.add_argument("--sort-by", default=None)
    search.add_argument("--sort-order", choices=("asc", "desc"), default=None)
    search.add_argument("--aggs", default=None)
    search.add_argument("--start-timestamp", type=int, default=None)
    search.add_argument("--end-timestamp", type=int, default=None)
    search.set_defaults(func=cmd_index_search)
    merge = index_sub.add_parser("merge")
    merge.add_argument("--index", required=True)
    merge.set_defaults(func=cmd_index_merge)

    source = sub.add_parser("source", help="source management")
    source_sub = source.add_subparsers(dest="subcommand", required=True)
    source_create = source_sub.add_parser("create")
    source_create.add_argument("--index", required=True)
    source_create.add_argument("--source-config", required=True)
    source_create.set_defaults(func=cmd_source_create)
    source_list = source_sub.add_parser("list")
    source_list.add_argument("--index", required=True)
    source_list.set_defaults(func=cmd_source_list)
    source_delete = source_sub.add_parser("delete")
    source_delete.add_argument("--index", required=True)
    source_delete.add_argument("--source", required=True)
    source_delete.set_defaults(func=cmd_source_delete)
    for toggle_name in ("enable", "disable"):
        toggle = source_sub.add_parser(toggle_name)
        toggle.add_argument("--index", required=True)
        toggle.add_argument("--source", required=True)
        toggle.set_defaults(func=cmd_source_toggle)
    reset = source_sub.add_parser("reset-checkpoint")
    reset.add_argument("--index", required=True)
    reset.add_argument("--source", required=True)
    reset.set_defaults(func=cmd_source_reset_checkpoint)

    split = sub.add_parser("split", help="split management")
    split_sub = split.add_subparsers(dest="subcommand", required=True)
    split_list = split_sub.add_parser("list")
    split_list.add_argument("--index", required=True)
    split_list.set_defaults(func=cmd_split_list)
    split_desc = split_sub.add_parser("describe")
    split_desc.add_argument("--index", required=True)
    split_desc.add_argument("--split", required=True)
    split_desc.set_defaults(func=cmd_split_describe)
    split_mark = split_sub.add_parser("mark-for-deletion")
    split_mark.add_argument("--index", required=True)
    split_mark.add_argument("--splits", required=True,
                            help="comma-separated split ids")
    split_mark.set_defaults(func=cmd_split_mark_for_deletion)

    trace = sub.add_parser("trace", help="flight-recorder trace export")
    trace_sub = trace.add_subparsers(dest="subcommand", required=True)
    trace_export = trace_sub.add_parser(
        "export", help="write the device timeline as Perfetto JSON")
    trace_export.add_argument("--out", required=True,
                              help="output path (e.g. trace.json)")
    trace_export.add_argument("--endpoint", default=None,
                              help="running node's REST host:port "
                                   "(default: this process's recorder)")
    trace_export.add_argument("--limit", type=int, default=0,
                              help="max events (0 = everything buffered)")
    trace_export.set_defaults(func=cmd_trace_export)

    tool = sub.add_parser("tool", help="maintenance tools")
    tool_sub = tool.add_subparsers(dest="subcommand", required=True)
    gc = tool_sub.add_parser("gc")
    gc.set_defaults(func=cmd_tool_gc)
    extract = tool_sub.add_parser("extract-split")
    extract.add_argument("--index", required=True)
    extract.add_argument("--split", required=True)
    extract.add_argument("--output-dir", required=True)
    extract.set_defaults(func=cmd_tool_extract_split)
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except BrokenPipeError:
        # output piped into a pager/head that closed early — not an error
        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        return 0
    except Exception as exc:  # noqa: BLE001 - CLI surface
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
