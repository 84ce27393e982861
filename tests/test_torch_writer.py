"""The port's `SplitWriter` and otel-traces generator against the JAX
package's: the same docs (or the same `(num_docs, seed)`) give the same
split bytes.

The port's writer always builds postings in Python; the JAX writer takes
its native builder (host C++) for default-tokenized text when it is
available, which writes the same arrays and adds a `"native"` marker to
the field's footer meta. So the bytes are held against the JAX Python path
(its native probe switched off), and the arrays against the native path
where it loads.
"""

import numpy as np
import pytest

import quickwit_tpu.index.writer as j_writer
from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.synthetic import synthetic_otel_split as j_otel
from quickwit_tpu.models import doc_mapper as jdm
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.index import SplitWriter as TSplitWriter
from quickwit_tpu_torch.index.synthetic import synthetic_otel_split as t_otel
from quickwit_tpu_torch.models import doc_mapper as tdm


def _mapper(dm, case):
    F, T = dm.FieldMapping, dm.FieldType
    ts = F("ts", T.DATETIME, fast=True, input_formats=("unix_timestamp",))
    if case == "text":
        fields = [ts, F("body", T.TEXT),
                  F("level", T.TEXT, tokenizer="raw", fast=True),
                  F("phrase", T.TEXT, record="position")]
    elif case == "multivalued":
        fields = [ts, F("tags", T.TEXT, tokenizer="raw", fast=True),
                  F("hosts", T.TEXT, tokenizer="raw", fast=True,
                    normalizer="lowercase")]
    elif case == "numeric":
        fields = [ts, F("small", T.U64, fast=True),
                  F("wide", T.I64, fast=True),
                  F("huge", T.U64, fast=True),
                  F("ratio", T.F64, fast=True),
                  F("flag", T.BOOL, fast=True),
                  F("sparse", T.I64, fast=True)]
    else:   # dynamic
        return dm.DocMapper(field_mappings=[ts, F("body", T.TEXT)],
                            timestamp_field="ts", mode="dynamic",
                            default_search_fields=("body",))
    return dm.DocMapper(field_mappings=fields, timestamp_field="ts",
                        default_search_fields=(fields[1].name,))


def _docs(case):
    rng = np.random.RandomState({"text": 1, "multivalued": 2, "numeric": 3,
                                 "dynamic": 4}[case])
    words = ["alpha", "Beta", "gamma", "delta", "über", "the", "x" * 300]
    docs = []
    for i in range(1500):
        doc = {"ts": 1_600_000_000 + i * 7}
        if case == "text":
            doc["body"] = " ".join(rng.choice(words, rng.randint(1, 9)))
            doc["level"] = ["INFO", "WARN", "ERROR"][i % 3]
            doc["phrase"] = [" ".join(rng.choice(words, 3)), "the end"]
        elif case == "multivalued":
            doc["tags"] = list(rng.choice([f"t{j}" for j in range(50)],
                                          rng.randint(1, 5)))
            if i % 4:
                doc["hosts"] = ["Host-A", "host-a", f"HOST-{i % 9}"]
        elif case == "numeric":
            doc.update(small=int(rng.randint(0, 200)),
                       wide=int(rng.randint(-2**40, 2**40)),
                       huge=int(2**63 + rng.randint(0, 1000)),
                       ratio=float(rng.choice([-0.0, 0.0, 1.5]) * i),
                       flag=bool(i % 2))
            if i % 5 == 0:
                doc["sparse"] = int(rng.randint(-50, 50) * 1000)
        else:
            doc["body"] = "dynamic doc " + str(i)
            doc["attrs"] = {"n": i % 7, "s": f"v{i % 3}",
                            "mixed": (i if i % 2 else float(i) / 2)}
            if i % 3 == 0:
                doc["only_some"] = [True, False]
        docs.append(doc)
    return docs


def _write(Writer, dm, case):
    writer = Writer(_mapper(dm, case))
    for doc in _docs(case):
        writer.add_json_doc(doc)
    return writer.finish()


@pytest.mark.parametrize("impact", ["impact", "no_impact"])
@pytest.mark.parametrize("packed", ["packed", "raw"])
@pytest.mark.parametrize("case", ["text", "multivalued", "numeric",
                                  "dynamic"])
def test_writer_bytes_match_jax_python_path(monkeypatch, case, packed,
                                            impact):
    monkeypatch.setenv("QW_DISABLE_PACKED", "1" if packed == "raw" else "0")
    monkeypatch.setenv("QW_DISABLE_IMPACT",
                       "1" if impact == "no_impact" else "0")
    monkeypatch.setattr(j_writer, "_native_capable", lambda fm: None)
    want = _write(j_writer.SplitWriter, jdm, case)
    got = _write(TSplitWriter, tdm, case)
    assert got == want


def _arrays(data):
    storage = JRamStorage(JUri.parse("ram:///writer-arrays"))
    storage.put("s.split", data)
    reader = JSplitReader(storage, "s.split")
    footer = reader.footer
    return ({name: reader.array(name).tobytes() for name in footer.arrays},
            {name: {k: v for k, v in meta.items() if k != "native"}
             for name, meta in footer.fields.items()})


def test_writer_arrays_match_jax_native_path():
    from quickwit_tpu.native import load_fastindex
    if load_fastindex() is None:
        pytest.skip("the JAX package's native builder does not load here")
    want = _arrays(_write(j_writer.SplitWriter, jdm, "text"))
    got = _arrays(_write(TSplitWriter, tdm, "text"))
    assert got == want


def test_writer_layouts_are_the_ones_asked_for(monkeypatch):
    """The numeric case writes u8/u16 packed lanes (and raw f64 and wide
    columns), the multivalued case writes pair arrays."""
    monkeypatch.setenv("QW_DISABLE_PACKED", "0")
    storage = JRamStorage(JUri.parse("ram:///writer-layouts"))
    storage.put("n.split", _write(TSplitWriter, tdm, "numeric"))
    storage.put("m.split", _write(TSplitWriter, tdm, "multivalued"))
    numeric = JSplitReader(storage, "n.split").footer
    assert {"col.small.packed", "col.sparse.packed", "col.ratio.values",
            "col.huge.packed"} <= set(numeric.arrays)
    assert numeric.fields["small"]["packed"]["bit_width"] == 8
    multi = JSplitReader(storage, "m.split").footer
    assert {"col.tags.mv_docs", "col.tags.mv_ords"} <= set(multi.arrays)
    assert multi.fields["tags"]["multivalued"]


@pytest.mark.parametrize("seed", [3, 7])
def test_otel_split_bytes_match_jax(seed):
    assert t_otel(50_000, seed=seed) == j_otel(50_000, seed=seed)
