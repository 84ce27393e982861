"""The port's native builder, merge and comparator against the JAX package's.

`quickwit_tpu_torch/native/` carries the JAX package's C++ sources byte
for byte and its loader. Held here, on the CPU with the host's g++:

- the port's native split bytes equal the JAX package's native bytes (a
  `record: position` text field with non-ASCII and overlong tokens, an
  empty doc, a dynamic-mode field under the `default` tokenizer, and more
  than `FLUSH_VALUES` values in one field);
- the port's native k-way merge equals the JAX native merge over
  impact-ordered (format v3) inputs, in append order and under the
  timestamp reorder, and takes `_merge_inverted_native`;
- the port's native split equals its Python split apart from the
  `"native"` footer marker, and its native merge the Python merge;
- `QW_DISABLE_NATIVE=1` gives the Python path;
- a source newer than its library rebuilds it, a library newer than its
  source is reused;
- two processes building into one directory at once both load a whole
  library;
- `leafbench`'s counts equal the port leaf's `num_hits` on a 5,000-doc
  hdfs split for the flagship term and c2's shape.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from chip_smoke import leafbench_bool_range_count, leafbench_term_count
from test_torch_indexing import force_python_paths

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIELDS = [
    {"name": "ts", "type": "datetime", "fast": True,
     "input_formats": ["unix_timestamp"]},
    {"name": "body", "type": "text", "record": "position"},
    {"name": "title", "type": "text"},
    {"name": "level", "type": "text", "tokenizer": "raw", "fast": True},
    {"name": "n", "type": "u64", "fast": True},
]
STATIC_MAPPING = {"field_mappings": FIELDS, "timestamp_field": "ts",
                  "default_search_fields": ["body"]}
DYNAMIC_MAPPING = {
    "field_mappings": FIELDS[:2], "timestamp_field": "ts", "mode": "dynamic",
    "dynamic_mapping": {"tokenizer": "default", "record": "position",
                        "fast": False},
    "default_search_fields": ["body"]}

WORDS = ["alpha", "beta", "gamma", "über", "ÊTRE", "привет", "東京", "naïve",
         "x" * 300, "punct!!!", "the", "a"]


def docs_for(case, seed=0, n=None, ts0=1_600_000_000):
    """Docs of one case, made from `seed` with numpy."""
    rng = np.random.RandomState(seed)
    n = n or {"text": 400, "dynamic": 300, "many_values": 3_000}[case]
    out = []
    for i in range(n):
        words = [WORDS[w] for w in rng.randint(0, len(WORDS),
                                               size=rng.randint(0, 9))]
        doc = {"ts": ts0 + int(rng.randint(0, 86_400)),
               "body": " ".join(words)}
        if case == "text":
            doc.update(title=f"title {i % 7} {WORDS[i % len(WORDS)]}",
                       level=["INFO", "WARN", "ERROR"][i % 3], n=i)
            if i % 50 == 0:
                doc = {"ts": doc["ts"]}     # no field but the timestamp
        elif case == "dynamic":
            doc.update(note=f"note {WORDS[i % 5]} {i % 3}",
                       attrs={"host": f"h{i % 4}", "path": "/a/b ünï"})
        else:   # three body values per doc: > FLUSH_VALUES in all
            doc["body"] = [doc["body"], f"v {i}", WORDS[i % len(WORDS)]]
            doc.update(title=f"t{i}", level="INFO", n=i)
        out.append(doc)
    return out


def load(root):
    def mod(path):
        return importlib.import_module(f"{root}.{path}")
    return mod


def write(root, mapping, docs):
    """Split bytes from `root`'s SplitWriter."""
    mod = load(root)
    writer = mod("index.writer").SplitWriter(
        mod("models.doc_mapper").DocMapper.from_dict(mapping))
    for doc in docs:
        writer.add_json_doc(doc)
    return writer.finish()


def reader_of(root, data, name="s.split"):
    mod = load(root)
    storage = mod("storage.ram").RamStorage(
        mod("common.uri").Uri.parse(f"ram:///native-{root}"))
    storage.put(name, data)
    return mod("index.reader").SplitReader(storage, name)


def arrays_and_fields(root, data):
    """A split's arrays (bytes) and its fields' footer meta less the
    `"native"` marker."""
    reader = reader_of(root, data)
    footer = reader.footer
    return ({name: reader.array(name).tobytes() for name in footer.arrays},
            {name: {k: v for k, v in meta.items() if k != "native"}
             for name, meta in footer.fields.items()})


def native_fields(root, data):
    return sorted(name for name, meta in reader_of(root, data).footer
                  .fields.items() if meta.get("native"))


@pytest.fixture(scope="module")
def natives():
    """Both packages' fastindex modules. The JAX loader builds into one
    shared temporary file, so a process whose first build lost that race
    to another process's has cached None: the library is in place by now,
    so that package loads again. A machine without g++ skips; with g++, a
    module that still does not load fails."""
    out = {}
    for root in PACKAGES:
        native = load(root)("native")
        module = native.load_fastindex()
        if module is None:
            native._cached = "unset"
            module = native.load_fastindex()
        out[root] = module
    missing = sorted(root for root, module in out.items() if module is None)
    if missing and shutil.which("g++"):
        pytest.fail(f"g++ is here but fastindex did not load in {missing}")
    if missing:
        pytest.skip("no g++ here to build fastindex")
    return out


# --- the writer ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["text", "dynamic", "many_values"])
def test_native_split_bytes_equal_jax_native(natives, case):
    mapping = DYNAMIC_MAPPING if case == "dynamic" else STATIC_MAPPING
    docs = docs_for(case)
    want = write("quickwit_tpu", mapping, docs)
    got = write("quickwit_tpu_torch", mapping, docs)
    assert got == want
    marked = native_fields("quickwit_tpu_torch", got)
    assert "body" in marked and "level" not in marked
    if case == "dynamic":
        assert {"note", "attrs.host"} <= set(marked)
    if case == "many_values":
        writer_mod = load("quickwit_tpu_torch")("index.writer")
        values = sum(len(d["body"]) for d in docs)
        assert values > writer_mod._NativeInvertedFieldBuilder.FLUSH_VALUES


@pytest.mark.parametrize("case", ["text", "dynamic", "many_values"])
def test_native_split_equals_python_split_but_the_marker(natives, case):
    mapping = DYNAMIC_MAPPING if case == "dynamic" else STATIC_MAPPING
    docs = docs_for(case, seed=1)
    native = write("quickwit_tpu_torch", mapping, docs)
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        python = write("quickwit_tpu_torch", mapping, docs)
    assert native_fields("quickwit_tpu_torch", native)
    assert native_fields("quickwit_tpu_torch", python) == []
    assert arrays_and_fields("quickwit_tpu_torch", native) == \
        arrays_and_fields("quickwit_tpu_torch", python)


def test_disable_native_env_gives_the_python_path(natives, monkeypatch):
    native_mod = load("quickwit_tpu_torch")("native")
    docs = docs_for("text", seed=2, n=60)
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        want = write("quickwit_tpu_torch", STATIC_MAPPING, docs)
    monkeypatch.setenv("QW_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native_mod, "_cached", "unset")
    monkeypatch.setattr(native_mod, "_leafbench_cached", "unset")
    assert native_mod.load_fastindex() is None
    assert native_mod.load_leafbench() is None
    assert write("quickwit_tpu_torch", STATIC_MAPPING, docs) == want


# --- the merge ----------------------------------------------------------------

def split_set(root, seed):
    """Three native splits over overlapping day ranges, in one storage."""
    mod = load(root)
    storage = mod("storage.ram").RamStorage(
        mod("common.uri").Uri.parse(f"ram:///native-merge-{root}"))
    readers = []
    for i in range(3):
        docs = docs_for("text", seed=seed + i, n=700,
                        ts0=1_600_000_000 + 40_000 * (2 - i))
        storage.put(f"m{i}.split", write(root, STATIC_MAPPING, docs))
        readers.append(mod("index.reader").SplitReader(storage,
                                                       f"m{i}.split"))
    return readers


@pytest.mark.parametrize("reorder", [None, "ts"])
def test_native_merge_equals_jax_native_merge(natives, reorder, monkeypatch):
    merge_mod = load("quickwit_tpu_torch")("index.merge_arrays")
    calls = []
    native_merge = merge_mod._merge_inverted_native

    def counted(*args, **kw):
        calls.append(args[2])
        return native_merge(*args, **kw)

    monkeypatch.setattr(merge_mod, "_merge_inverted_native", counted)
    out = {}
    for root in PACKAGES:
        readers = split_set(root, seed=10)
        assert "impact" in readers[0].footer.fields["title"]   # format v3
        out[root] = load(root)("index.merge_arrays").merge_splits(
            readers, reorder_field=reorder)
    assert out["quickwit_tpu_torch"] == out["quickwit_tpu"]
    assert {"body", "title"} <= set(calls)   # every inverted field


def test_native_merge_equals_python_merge(natives):
    merge_mod = load("quickwit_tpu_torch")("index.merge_arrays")
    readers = split_set("quickwit_tpu_torch", seed=20)
    native = merge_mod.merge_splits(readers, reorder_field="ts")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(load("quickwit_tpu_torch")("native"), "_cached", None)
        python = merge_mod.merge_splits(readers, reorder_field="ts")
    assert native == python


# --- the build ----------------------------------------------------------------

def test_a_newer_source_rebuilds_and_an_older_one_does_not(tmp_path,
                                                           monkeypatch):
    native_mod = load("quickwit_tpu_torch")("native")
    monkeypatch.setattr(native_mod, "_build_dir", lambda: str(tmp_path))
    so_path = native_mod._compile("leafbench.cpp",
                                  needs_python_include=False)
    if so_path is None:
        pytest.skip("g++ did not build leafbench here")
    src = os.path.join(os.path.dirname(native_mod.__file__), "leafbench.cpp")
    built = os.path.getmtime(so_path)
    assert built >= os.path.getmtime(src)
    # a library newer than its source is reused as it is
    assert native_mod._compile("leafbench.cpp",
                               needs_python_include=False) == so_path
    assert os.path.getmtime(so_path) == built
    # a source newer than its library (an edit after the build) rebuilds
    stale = os.path.getmtime(src) - 100
    os.utime(so_path, (stale, stale))
    assert native_mod._compile("leafbench.cpp",
                               needs_python_include=False) == so_path
    assert os.path.getmtime(so_path) >= os.path.getmtime(src)
    assert sorted(os.listdir(tmp_path)) == ["leafbench.so"]


BUILD_SCRIPT = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("qw_native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native._build_dir = lambda: sys.argv[2]
sys.stdin.readline()            # start both builds together
module = native.load_fastindex()
print(json.dumps({"loaded": module is not None and
                  hasattr(module, "merge_inverted")}))
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    init = os.path.join(REPO, "quickwit_tpu_torch", "native", "__init__.py")
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, init, str(tmp_path)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "QW_DISABLE_NATIVE": "0"}) for _ in range(2)]
    for proc in procs:
        proc.stdin.write("go\n")
        proc.stdin.flush()
    outs = [json.loads(proc.communicate(timeout=180)[0]) for proc in procs]
    if not any(out["loaded"] for out in outs):
        pytest.skip("g++ did not build fastindex here")
    assert outs == [{"loaded": True}, {"loaded": True}]
    assert sorted(os.listdir(tmp_path)) == ["fastindex.so"]


# --- leafbench ----------------------------------------------------------------

def test_leafbench_counts_equal_the_port_leaf():
    from quickwit_tpu_torch.index.synthetic import (
        HDFS_MAPPER, body_term, synthetic_hdfs_split)
    from quickwit_tpu_torch.native import load_leafbench
    from quickwit_tpu_torch.query.ast import Bool, Range, RangeBound, Term
    from quickwit_tpu_torch.search.leaf import (
        leaf_search_single_split, prepare_plan_only)
    from quickwit_tpu_torch.search.models import SearchRequest
    lib = load_leafbench()
    if lib is None:
        pytest.skip("g++ did not build leafbench here")
    reader = reader_of("quickwit_tpu_torch", synthetic_hdfs_split(5_000,
                                                                  seed=7))
    day_us, t0_us = 86_400 * 1_000_000, 1_600_000_000 * 1_000_000
    flagship = SearchRequest(index_ids=["hdfs-logs"],
                             query_ast=Term("severity_text", "ERROR"),
                             max_hits=10)
    c2 = SearchRequest(index_ids=["hdfs-logs"], query_ast=Bool(
        must=(Term("severity_text", "ERROR"),),
        should=(Term("body", body_term(3)), Term("body", body_term(7))),
        filter=(Range("timestamp", lower=RangeBound(t0_us + day_us, True),
                      upper=RangeBound(t0_us + 4 * day_us, False)),)),
        max_hits=100)
    for request, count in ((flagship, leafbench_term_count),
                           (c2, leafbench_bool_range_count)):
        want = leaf_search_single_split(request, HDFS_MAPPER, reader, "s",
                                        device="cpu").num_hits
        plan = prepare_plan_only(request, HDFS_MAPPER, reader, "s")
        assert want > 0
        assert count(lib, plan, request.max_hits) == want
