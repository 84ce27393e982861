"""CUDA-only check of the node's REST front door: a port node on the card
behind a `RestServer` creates an index over `HDFS_MAPPER`'s fields and
ingests 16,384 hdfs-logs docs (`chip_smoke.write_docs`) in two requests
over REST; its flagship, c2 (ES-DSL, top-100 by timestamp) and c3 answers
must equal, as JSON minus wall times, those of a CPU node over the same
`file://` files, and its scored flagship must launch `score_topk_lanes`.
Marked `gpu`; it skips where there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu
tests/test_torch_cuda_serve.py` runs it on the card.
"""

import json
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import WRITE_T0, hdfs_requests, serve_requests, write_docs
from quickwit_tpu_torch.index import synthetic
from quickwit_tpu_torch.index.synthetic import HDFS_MAPPER, body_term
from quickwit_tpu_torch.ops.kernels import score_topk as st
from quickwit_tpu_torch.query.ast import Term
from quickwit_tpu_torch.search.models import SearchRequest
from quickwit_tpu_torch.serve import Node, NodeConfig, RestServer
from quickwit_tpu_torch.storage import StorageResolver
from test_torch_rest_api import assert_same_json, send, strip

DOCS, REQUEST_DOCS = 16_384, 8_192


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_rest_node_on_cuda_equals_cpu(cuda_device, tmp_path):
    files = dict(metastore_uri=f"file://{tmp_path}/metastore",
                 default_index_root_uri=f"file://{tmp_path}/indexes")
    servers = []

    def start(node_id, device, **kw):
        node = Node(NodeConfig(node_id=node_id, rest_port=0, device=device,
                               data_dir=str(tmp_path / node_id), **files,
                               **kw),
                    storage_resolver=StorageResolver.default())
        server = RestServer(node)
        server.start()
        servers.append(server)
        return server.port

    try:
        gpu = start("gpu-node", "cuda")
        status, _ = send(gpu, "POST", "/api/v1/indexes", {
            "index_id": "hdfs-logs", "doc_mapping": HDFS_MAPPER.to_dict(),
            "indexing_settings": {"split_num_docs_target": REQUEST_DOCS}})
        assert status == 200
        docs = write_docs(synthetic, DOCS, REQUEST_DOCS, seed=7)
        for lo in range(0, DOCS, REQUEST_DOCS):
            ndjson = "\n".join(json.dumps(d)
                               for d in docs[lo:lo + REQUEST_DOCS]).encode()
            status, out = send(gpu, "POST",
                               "/api/v1/hdfs-logs/ingest?commit=force",
                               ndjson)
            assert status == 200
            assert out["num_ingested_docs"] == REQUEST_DOCS
        cpu = start("cpu-node", "cpu", roles=("searcher",))
        flagship_aggs = hdfs_requests(SearchRequest, Term,
                                      body_term)["flagship"].aggs
        m = SimpleNamespace(body_term=body_term)
        lanes = st.score_topk_lanes.launches
        for name, (method, path, body) in serve_requests(
                m, flagship_aggs, WRITE_T0).items():
            status, got = send(gpu, method, path, body)
            assert status == 200, (name, got)
            status, want = send(cpu, method, path, body)
            assert status == 200, (name, want)
            assert_same_json(strip(want), strip(got))
        assert st.score_topk_lanes.launches > lanes
        assert got["hits"]["total"]["value"] > 0
    finally:
        for server in servers:
            server.stop()

