"""Config loading: YAML/JSON with environment-variable interpolation.

Role of the reference's `quickwit-config` (`node_config/serialize.rs`):
layered node config (defaults < file < env) with `${VAR}` / `${VAR:-default}`
interpolation, plus index-config files for `quickwit index create`.

Counterpart of the JAX package's `config/node_config.py`. PyYAML is
imported when a file is read, so a node configured from the environment
alone needs none. `QW_DEVICE` (file key `device`) names the device the
node searches on, the port's counterpart of `QW_JAX_PLATFORM`; absent
means `cuda`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

from ..serve.node import NodeConfig

_ENV_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::-([^}]*))?\}")


def interpolate_env(text: str, env: Optional[dict[str, str]] = None) -> str:
    env = env if env is not None else dict(os.environ)

    def replace(match: re.Match) -> str:
        name, default = match.group(1), match.group(2)
        if name in env:
            return env[name]
        if default is not None:
            return default
        raise ValueError(f"environment variable {name!r} is not set and has no default")

    return _ENV_RE.sub(replace, text)


def _load_yaml(path: str, env: Optional[dict[str, str]] = None) -> dict[str, Any]:
    import yaml
    with open(path) as f:
        raw = f.read()
    return yaml.safe_load(interpolate_env(raw, env)) or {}


def load_source_config(path: str,
                       env: Optional[dict[str, str]] = None) -> dict[str, Any]:
    """Source config file (yaml/json) -> the dict the source-create
    route consumes (reference: `source_config/mod.rs` yaml shape)."""
    data = _load_yaml(path, env)
    if not isinstance(data, dict):
        raise ValueError(
            f"source config {path} must be a YAML/JSON object, "
            f"got {type(data).__name__}")
    # field-level validation lives in parse_source_config (the one
    # shared REST/CLI site); this loader only owns file -> dict
    data.pop("version", None)
    return data


def load_node_config(path: Optional[str] = None,
                     env: Optional[dict[str, str]] = None) -> NodeConfig:
    """Precedence: defaults < config file < QW_* env vars
    (reference: `node_config/serialize.rs` load order)."""
    data: dict[str, Any] = {}
    if path:
        data = _load_yaml(path, env)
    environ = env if env is not None else dict(os.environ)

    def pick(env_key: str, file_key: str, default):
        if env_key in environ:
            return environ[env_key]
        return data.get(file_key, default)

    roles_raw = pick("QW_ENABLED_SERVICES", "enabled_services",
                     data.get("roles", "searcher,indexer,metastore,janitor,control_plane"))
    if isinstance(roles_raw, str):
        roles = tuple(r.strip() for r in roles_raw.split(",") if r.strip())
    else:
        roles = tuple(roles_raw)
    rest = data.get("rest", {})
    tls = rest.get("tls") or {}  # bare "tls:" key parses as None
    return NodeConfig(
        node_id=str(pick("QW_NODE_ID", "node_id", "node-0")),
        cluster_id=str(pick("QW_CLUSTER_ID", "cluster_id", "quickwit-tpu")),
        roles=roles,
        metastore_uri=str(pick("QW_METASTORE_URI", "metastore_uri",
                               "file:///tmp/quickwit_tpu/metastore")),
        default_index_root_uri=str(pick(
            "QW_DEFAULT_INDEX_ROOT_URI", "default_index_root_uri",
            "file:///tmp/quickwit_tpu/indexes")),
        rest_host=str(environ.get("QW_REST_HOST",
                                  rest.get("listen_host", "127.0.0.1"))),
        rest_port=int(environ.get("QW_REST_PORT",
                                  rest.get("listen_port", 7280))),
        peers=tuple(data.get("peer_seeds", ())),
        tls_cert_path=tls.get("cert_path"),
        tls_key_path=tls.get("key_path"),
        tls_ca_path=tls.get("ca_path"),
        tls_skip_verify=bool(tls.get("skip_verify", False)),
        tls_verify_client=bool(tls.get("verify_client", False)),
        gossip_enabled=bool(data.get("gossip", False)),
        replication_factor=int(pick("QW_REPLICATION_FACTOR",
                                    "replication_factor", 1)),
        offload=((data.get("searcher", {}) or {}).get("offload")
                 if isinstance((data.get("searcher", {}) or {}).get(
                     "offload"), dict) else None),
        offload_endpoint=(data.get("searcher", {}) or {}).get(
            "offload_endpoint"),
        offload_max_local_splits=int((data.get("searcher", {}) or {}).get(
            "offload_max_local_splits", 16)),
        **_split_cache_fields(data),
        tenancy=(data.get("tenancy")
                 if isinstance(data.get("tenancy"), dict) else None),
        grpc_port=(int(environ["QW_GRPC_PORT"])
                   if "QW_GRPC_PORT" in environ
                   else (int((data.get("grpc", {}) or {})["listen_port"])
                         if (data.get("grpc") or {}).get("listen_port")
                         is not None else None)),
        device=pick("QW_DEVICE", "device", None),
    )


def _split_cache_fields(data: dict) -> dict[str, Any]:
    """`searcher.split_cache: {root_path, max_bytes, max_splits}` → the
    NodeConfig disk-split-cache fields (absent/None = disabled)."""
    cache = (data.get("searcher", {}) or {}).get("split_cache")
    if not isinstance(cache, dict) or not cache.get("root_path"):
        return {}
    return {
        "split_cache_dir": str(cache["root_path"]),
        "split_cache_max_bytes": int(cache.get("max_bytes", 10 << 30)),
        "split_cache_max_splits": int(cache.get("max_splits", 10_000)),
    }


def load_index_config(path: str, env: Optional[dict[str, str]] = None) -> dict[str, Any]:
    """Index config file (yaml/json) → the dict `IndexService.create_index`
    consumes; field mapping entries use the same shape as the reference's
    index config yaml."""
    data = _load_yaml(path, env)
    if "version" in data:
        data.pop("version")
    doc_mapping = data.get("doc_mapping", {})
    # accept the reference's nested field_mappings with `name`/`type` keys
    # verbatim; flatten "object"-typed nested mappings into dotted paths
    flat: list[dict[str, Any]] = []

    def walk(entries: list[dict[str, Any]], prefix: str = "") -> None:
        for entry in entries:
            name = f"{prefix}{entry['name']}"
            if entry.get("type") == "object":
                walk(entry.get("field_mappings", []), prefix=f"{name}.")
            else:
                flat.append({**entry, "name": name})

    walk(doc_mapping.get("field_mappings", []))
    doc_mapping = {**doc_mapping, "field_mappings": flat}
    data["doc_mapping"] = doc_mapping
    return data
