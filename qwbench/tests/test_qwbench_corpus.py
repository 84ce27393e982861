"""The benchmark's corpus builders against the port's own write path, on
the CPU at small sizes: the same raw documents through `SplitWriter` (its
per-term `apply_impact_ordering` included) give the same arrays. Run with
`python -m pytest qwbench/tests -q`; the `gpu` tests need a card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qwbench import cells
from qwbench.corpus import common, otel_traces
from qwbench.tests import logs_corpus
from quickwit_tpu_torch.index.format import (
    SplitFileBuilder, SplitFooter, read_footer,
)
from quickwit_tpu_torch.index.writer import SplitWriter
from quickwit_tpu_torch.models.doc_mapper import DocMapper


def small_otel(docs=2500):
    config = cells.load_config("otel-traces-64x512k")
    config["docs_per_split"] = docs
    config["splits"] = 2
    return config


def arrays_of(split: bytes) -> tuple[SplitFooter, dict]:
    footer = read_footer(lambda a, b: split[a:b], len(split))
    out = {}
    for name, meta in footer.arrays.items():
        out[name] = np.frombuffer(split[meta.offset:meta.offset
                                        + meta.nbytes],
                                  dtype=meta.dtype).reshape(meta.shape)
    return footer, out


def writer_split(config: dict, docs: list[dict]) -> bytes:
    writer = SplitWriter(DocMapper.from_dict(config["doc_mapping"]))
    for doc in docs:
        writer.add_json_doc(doc)
    return writer.finish()


def otel_writer_split(config: dict, raw: dict) -> bytes:
    """The same spans through `SplitWriter`, as the OTLP ingest sends
    them: start times in ns, durations in ms."""
    return writer_split(config, [
        {"span_start_timestamp_nanos": int(t) * 1_000_000,
         "span_duration_millis": int(d),
         "service_name": config["services"][int(s)]}
        for t, d, s in zip(raw["ts"].tolist(), raw["duration"].tolist(),
                           raw["service"].tolist())])


STORE = {"store.data", "store.block_offsets", "store.block_first_doc"}


def assert_same_split(ours: bytes, theirs: bytes,
                      store: bool = False) -> None:
    """Every array, the doc store's only with `store` (otel's is empty:
    dashboards fetch no documents), and every field's metadata."""
    f_ours, a_ours = arrays_of(ours)
    f_theirs, a_theirs = arrays_of(theirs)
    assert set(a_ours) == set(a_theirs)
    for name in sorted(set(a_theirs) - (set() if store else STORE)):
        assert a_ours[name].dtype == a_theirs[name].dtype, name
        np.testing.assert_array_equal(a_ours[name], a_theirs[name],
                                      err_msg=name)
    assert f_ours.num_docs == f_theirs.num_docs
    assert f_ours.time_range == f_theirs.time_range
    assert f_ours.fields == {k: {kk: vv for kk, vv in v.items()
                                 if kk != "native"}
                             for k, v in f_theirs.fields.items()}


def test_otel_split_equals_the_writers():
    config = small_otel()
    raw = otel_traces.draw(config, 2**33 + 5, "cpu", split=1)
    ours, _ = otel_traces.build(config, raw)
    assert_same_split(ours, otel_writer_split(config, raw))


def logs_split_pair(docs: int, seed: int, device="cpu"):
    """A small logs split through the corpus helpers and through
    `SplitWriter`, from the same raw documents."""
    config = logs_corpus.config()
    config["docs_per_split"] = docs
    raw = logs_corpus.draw(config, seed, device, split=2)
    ours, _ = logs_corpus.build(config, raw)
    cpu = {k: v.cpu() for k, v in raw.items()}
    theirs = writer_split(config, logs_corpus.documents(config, cpu))
    return ours, theirs


@pytest.mark.parametrize("docs", [700, 2500])
def test_text_field_and_doc_store_equal_the_writers(docs):
    """The body's postings with exact lengths, the u64 field's postings
    and the doc store, array by array, over one or several store blocks."""
    ours, theirs = logs_split_pair(docs, 2**33 + 17)
    assert_same_split(ours, theirs, store=True)
    _, arrays = arrays_of(ours)
    assert len(arrays["store.block_offsets"]) > (2 if docs > 2000 else 1)
    assert arrays["inv.body.fieldnorm"].max() > 3


def test_a_word_that_is_not_its_own_token_is_refused():
    from quickwit_tpu_torch.models.doc_mapper import FieldMapping, FieldType
    with pytest.raises(ValueError, match="tokenize"):
        common.text_field(SplitFileBuilder(), FieldMapping(
            "body", FieldType.TEXT), ["ok", "Not-one"],
            torch.tensor([0, 2]), torch.tensor([0, 1]), 128)


def test_otel_columns_keep_the_index_types():
    """Millisecond starts, whole-millisecond u64 durations, services
    skewed as the config states."""
    config = small_otel(docs=20000)
    raw = otel_traces.draw(config, 31, "cpu")
    ours, _ = otel_traces.build(config, raw)
    footer, arrays = arrays_of(ours)
    ts = footer.fields["span_start_timestamp_nanos"]
    assert ts["packed"]["for_scale"] == 1000          # ms in micros
    assert arrays["col.span_start_timestamp_nanos.packed"].dtype == np.uint32
    assert footer.fields["span_duration_millis"]["type"] == "u64"
    counts = np.bincount(raw["service"].numpy(),
                         minlength=len(config["services"]))
    by_traffic = [counts[config["services"].index(name)]
                  for name in config["services_by_traffic"]]
    assert by_traffic[0] > 5 * by_traffic[-1] > 0
    assert len(config["services"]) > 10   # terms(size 10) truncates


def test_same_seed_same_bytes():
    config = small_otel()
    module = otel_traces
    one, _ = module.build(config, module.draw(config, 99, "cpu"))
    two, _ = module.build(config, module.draw(config, 99, "cpu"))
    three, _ = module.build(config, module.draw(config, 100, "cpu"))
    assert one == two
    assert one != three


def test_impact_ordering_with_uneven_norms():
    """The vectorised impact ordering against the port's per-term one on
    postings whose docs have different lengths and repeated terms."""
    from quickwit_tpu_torch.index.format import SplitFileBuilder
    from quickwit_tpu_torch.index.impact import build_impact_arrays
    from quickwit_tpu_torch.models.doc_mapper import FieldMapping, FieldType
    rng = np.random.default_rng(3)
    n, n_pad, terms = 700, 1024, 40
    term = rng.integers(0, terms, 5000)
    doc = rng.integers(0, n, 5000)
    key, tf = np.unique(term * n_pad + doc, return_counts=True)
    term_s, doc_s = key // n_pad, key % n_pad
    norms = np.zeros(n_pad, dtype=np.int32)
    norms[:n] = rng.integers(1, 60, n)
    total = int(norms.sum())
    builder = SplitFileBuilder()
    blob = b"".join(f"t{k:03d}".encode() for k in range(terms))
    offsets = np.arange(terms + 1, dtype=np.int64) * 4
    common.inverted_field(builder, "f", blob, offsets,
                          torch.from_numpy(term_s), torch.from_numpy(doc_s),
                          torch.from_numpy(tf), torch.from_numpy(norms),
                          total, n, n_pad,
                          FieldMapping("f", FieldType.TEXT))
    footer = SplitFooter(num_docs=n, num_docs_padded=n_pad, arrays={},
                         fields={})
    _, ours = arrays_of(builder.finish(footer))
    dfs = np.bincount(term_s, minlength=terms).astype(np.int32)
    lens = (dfs + 127) // 128 * 128
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    ids = np.full(int(lens.sum()), n_pad, dtype=np.int32)
    tfs = np.zeros(int(lens.sum()), dtype=np.int32)
    rank = np.arange(len(term_s)) - np.concatenate(
        [[0], np.cumsum(dfs)[:-1]])[term_s]
    ids[offs[term_s] + rank] = doc_s
    tfs[offs[term_s] + rank] = tf
    want = build_impact_arrays(ids, tfs, offs, dfs, norms, total / n, n)
    for name, arr in zip(("postings.ids", "postings.tfs", "impact.quant",
                          "impact.bmax", "impact.scale"), want):
        np.testing.assert_array_equal(ours[f"inv.f.{name}"], arr,
                                      err_msg=name)


@pytest.mark.gpu
def test_otel_split_on_the_card_equals_the_writers(cuda):
    config = small_otel(docs=20000)
    raw = otel_traces.draw(config, 4242, cuda)
    ours, _ = otel_traces.build(config, raw)
    cpu_raw = {k: v.cpu() for k, v in raw.items()}
    assert_same_split(ours, otel_writer_split(config, cpu_raw))


@pytest.mark.gpu
def test_logs_split_on_the_card_equals_the_writers(cuda):
    ours, theirs = logs_split_pair(2500, 4243, cuda)
    assert_same_split(ours, theirs, store=True)
