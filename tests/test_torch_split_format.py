"""The port's split generator and reader against the JAX package's.

Split bytes are this system's weights: both engines must write the same
bytes for the same (num_docs, seed) and read the same arrays back.
"""

import numpy as np
import pytest

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.synthetic import (
    body_term as j_body_term, synthetic_hdfs_split as j_synthetic)
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.index.synthetic import (
    body_term as t_body_term, synthetic_hdfs_split as t_synthetic)
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage


@pytest.mark.parametrize("num_docs", [30_720, 50_000])
@pytest.mark.parametrize("seed", [7, 11])
def test_split_bytes_identical(num_docs, seed):
    assert t_synthetic(num_docs, seed=seed) == j_synthetic(num_docs, seed=seed)
    assert t_body_term(3) == j_body_term(3)


@pytest.mark.parametrize("num_docs", [30_720, 50_000])
def test_reader_reads_jax_written_split(num_docs):
    data = j_synthetic(num_docs, seed=7)
    js = JRamStorage(JUri.parse("ram:///fmt"))
    js.put("s.split", data)
    ts = TRamStorage(TUri.parse("ram:///fmt"))
    ts.put("s.split", data)
    j_reader, t_reader = JSplitReader(js, "s.split"), TSplitReader(ts, "s.split")

    assert (t_reader.num_docs, t_reader.num_docs_padded) == (
        j_reader.num_docs, j_reader.num_docs_padded)
    assert t_reader.footer.fields == j_reader.footer.fields
    assert t_reader.footer.extra == j_reader.footer.extra
    assert sorted(t_reader.footer.arrays) == sorted(j_reader.footer.arrays)
    for name in j_reader.footer.arrays:
        a, b = j_reader.array(name), t_reader.array(name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name

    for field, term in [("severity_text", "ERROR"), ("body", j_body_term(3)),
                        ("body", j_body_term(99_999)), ("body", "absent")]:
        j_info = j_reader.lookup_term(field, term)
        t_info = t_reader.lookup_term(field, term)
        assert (t_info is None) == (j_info is None)
        if j_info is None:
            continue
        assert tuple(vars(t_info).values()) == tuple(vars(j_info).values())
        for x, y in zip(j_reader.postings(field, j_info),
                        t_reader.postings(field, t_info)):
            assert np.array_equal(x, y)
    assert t_reader.column_dict("severity_text") == \
        j_reader.column_dict("severity_text")
    assert t_reader.impact_info("body") == j_reader.impact_info("body")
