"""Port parity for the native host readers: the LIBSVM parser
(``native/src/libsvm_parser.cpp``) and the GAME Avro decoder
(``native/src/avro_game.cpp``), each bound through the port's one host
library, against the JAX package's native readers and the port's Python
readers, bit for bit; the malformed-input and page-boundary cases of
``tests/test_native.py:43-145``, the Avro cases of ``:303,358`` and the
schema subset.  ``g++`` builds the library here, as on any host.
"""

import copy
import os

import numpy as np
import pytest
import torch

from photon_tpu.data.game_io import read_game_avro as jax_read_game_avro
from photon_tpu.data.libsvm import load_sparse_batch as jax_load
from photon_tpu.native import libsvm_native as jax_native
from photon_tpu_torch.data import avro_codec, game_io, libsvm
from photon_tpu_torch.data.fixtures import make_movielens_like
from photon_tpu_torch.data.game_io import read_game_avro, write_game_avro
from photon_tpu_torch.native import avro_native, libsvm_native
from photon_tpu_torch.native.build import build_error, get_lib

BAGS = {"global": "global", "per_user": "per_user"}
COLS = ["userId", "itemId"]


def test_host_library_builds_with_every_source():
    lib = get_lib()
    assert lib is not None, build_error()
    for entry in ("svm_parse", "gav_decode", "clos_edge_color"):
        assert hasattr(lib, entry)


def _write_libsvm(path, n=500, dim=100, seed=0, comments=True):
    """tests/test_native.py's file: sorted ids, +-1 labels, trailing and
    whole-line comments."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            k = int(rng.integers(1, 12))
            ids = np.sort(rng.choice(np.arange(1, dim), size=k, replace=False))
            lab = int(rng.choice([-1, 1]))
            f.write(f"{lab} " + " ".join(f"{j}:{rng.standard_normal():.6g}" for j in ids))
            if comments and i % 5 == 0:
                f.write(" # trailing comment")
            f.write("\n")
        if comments:
            f.write("\n# whole-line comment\n")


def _native_rows(path, zero_based=False):
    """The native CSR parse as ``(rows, labels, dim)``."""
    labels, row_ptr, ids, vals, dim = libsvm_native.parse_file_csr(path, zero_based)
    rows = [(ids[a:b], vals[a:b]) for a, b in zip(row_ptr[:-1], row_ptr[1:])]
    return rows, labels, dim


@pytest.mark.parametrize("zero_based", [False, True])
def test_native_parse_matches_reference_and_python(tmp_path, zero_based):
    path = str(tmp_path / "data.libsvm")
    _write_libsvm(path)
    csr = libsvm_native.parse_file_csr(path, zero_based)
    for got, want in zip(csr, jax_native.parse_file_csr(path, zero_based)):
        np.testing.assert_array_equal(got, want)
    rows, labels, dim = _native_rows(path, zero_based)
    py = libsvm.parse_libsvm(path, zero_based)
    assert dim == py.dim
    np.testing.assert_array_equal(labels, py.labels)
    assert len(rows) == len(py.rows)
    for (i1, v1), (i2, v2) in zip(rows, py.rows):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(v1, v2)


@pytest.mark.parametrize("binary", [True, False])
def test_batches_match_reference_and_python_path(tmp_path, monkeypatch, binary):
    """The native CSR batch equals the reference's batch and the port's
    Python-path batch bit for bit."""
    path = str(tmp_path / "data.libsvm")
    _write_libsvm(path, seed=1)
    tb, td, traw = libsvm.load_sparse_batch(path, binary_labels=binary, device="cpu")
    assert libsvm.last_reader == "native"
    jb, jd, jraw = jax_load(path, binary_labels=binary)
    monkeypatch.setattr(libsvm, "parse_csr_or_none", lambda p: None)
    pb, pd, praw = libsvm.load_sparse_batch(path, binary_labels=binary, device="cpu")
    assert libsvm.last_reader == "python"
    assert (td, traw) == (jd, jraw) == (pd, praw)
    for name in ("ids", "vals", "label", "offset", "weight"):
        want = np.asarray(getattr(jb, name))
        np.testing.assert_array_equal(getattr(tb, name).numpy(), want, name)
        np.testing.assert_array_equal(getattr(pb, name).numpy(), want, name)
    # Validation loads pad to the training dimension and refuse wider files.
    vb, vd, _ = libsvm.load_sparse_batch(path, dim=120, device="cpu")
    assert vd == 121 and int(vb.ids.max()) == 120
    with pytest.raises(ValueError, match=">= dim"):
        libsvm.load_sparse_batch(path, max_feature_dim=50, device="cpu")


def test_zero_based_and_empty_rows(tmp_path):
    path = str(tmp_path / "zb.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1.5 3:2.5\n0\n-1 7:0.25\n")
    rows, labels, dim = _native_rows(path, True)
    assert dim == 8
    np.testing.assert_array_equal(labels, [1.0, 0.0, -1.0])
    assert len(rows[1][0]) == 0
    np.testing.assert_array_equal(rows[0][0], [0, 3])


@pytest.mark.parametrize("text", [
    "1 3:not_a_number\n", "1 2: 3\n", "1 2:\n3 1:1\n", "1 3:+-2.5\n",
    "1 3000000000:1.0\n", "1 0:1.0\n",
])
def test_malformed_input_raises_in_both_parsers(tmp_path, text):
    path = str(tmp_path / "bad.libsvm")
    with open(path, "w") as f:
        f.write(text)
    with pytest.raises(ValueError):
        libsvm_native.parse_file_csr(path, False)
    with pytest.raises(ValueError):
        libsvm.parse_libsvm(path, False)
    with pytest.raises(ValueError):
        libsvm.load_sparse_batch(path, device="cpu")  # no fallback to Python
    with pytest.raises(ValueError):
        jax_native.parse_file_csr(path, False)


def test_page_boundary_without_trailing_newline(tmp_path):
    path = str(tmp_path / "page.libsvm")
    tail = "1 7:2.5"
    page = os.sysconf("SC_PAGESIZE")
    content = "#" + "x" * (page - len(tail) - 2) + "\n" + tail
    assert len(content) == page and not content.endswith("\n")
    with open(path, "w") as f:
        f.write(content)
    rows, labels, dim = _native_rows(path)
    assert len(rows) == 1 and dim == 7
    np.testing.assert_array_equal(labels, [1.0])
    np.testing.assert_array_equal(rows[0][1], [2.5])
    plus = tmp_path / "plus.libsvm"
    plus.write_text("+1 1:+2.5 3:-1.5\n-1 2:+0.5\n")
    rows, labels, dim = _native_rows(str(plus))
    py = libsvm.parse_libsvm(str(plus))
    np.testing.assert_array_equal(labels, py.labels)
    for (i1, v1), (i2, v2) in zip(rows, py.rows):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(v1, v2)


def _assert_same_read(got, want):
    (ds, maps), (ref, ref_maps) = got, want
    np.testing.assert_array_equal(ds.label, ref.label)
    np.testing.assert_array_equal(ds.offset, ref.offset)
    np.testing.assert_array_equal(ds.weight, ref.weight)
    assert set(ds.id_columns) == set(ref.id_columns)
    for c in ref.id_columns:
        np.testing.assert_array_equal(ds.id_columns[c], ref.id_columns[c])
    for s in ref.shards:
        assert list(maps[s].keys()) == list(ref_maps[s].keys())
        assert maps[s].intercept_id == ref_maps[s].intercept_id
        np.testing.assert_array_equal(ds.shard(s).ids, ref.shard(s).ids)
        np.testing.assert_array_equal(ds.shard(s).vals, ref.shard(s).vals)
        assert ds.shard(s).dim == ref.shard(s).dim


def test_native_avro_read_matches_reference(tmp_path, monkeypatch):
    """tests/test_native.py:303: the native columnar read equals the
    reference's ``read_game_avro`` and the port's Python reader bit for
    bit, building the maps and on fixed maps (features absent from them
    dropped, the intercept kept)."""
    data, maps = make_movielens_like(n_users=60, n_items=50, mean_ratings=8)
    path = str(tmp_path / "ml.avro")
    write_game_avro(path, data, maps)
    calls = []
    real = avro_native.decode_file

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(avro_native, "decode_file", spy)
    native = read_game_avro(path, BAGS, COLS)
    assert calls == [True] and game_io.last_reader == "native"
    ref = jax_read_game_avro(path, BAGS, COLS)
    _assert_same_read(native, ref)
    # Fixed maps: a map without the last key of the per-user bag.
    fixed = dict(native[1])
    keys = list(fixed["per_user"].keys())
    from photon_tpu.data.index_map import IndexMap as JaxIndexMap
    from photon_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap

    kept = [k for k in keys[:-2] if k != INTERCEPT_KEY]
    fixed["per_user"] = IndexMap.build(kept, intercept=True)
    jfixed = {s: JaxIndexMap.build([k for k in m.keys() if k != INTERCEPT_KEY],
                                   intercept=m.intercept_id is not None)
              for s, m in fixed.items()}
    got = read_game_avro(path, BAGS, COLS, index_maps=fixed)
    _assert_same_read(got, jax_read_game_avro(path, BAGS, COLS, index_maps=jfixed))
    monkeypatch.setenv("PHOTON_TPU_NO_NATIVE_AVRO", "1")
    python = read_game_avro(path, BAGS, COLS)
    assert game_io.last_reader == "python" and calls == [True, True]
    _assert_same_read(python, ref)
    _assert_same_read(read_game_avro(path, BAGS, COLS, index_maps=fixed), got)


def test_native_avro_skips_unwanted_fields_and_falls_back(tmp_path, monkeypatch):
    """tests/test_native.py:358: an extra plain double is skipped without
    storage; a field outside the subset (a map) takes the Python reader."""
    data, maps = make_movielens_like(n_users=20, n_items=15, mean_ratings=5)
    base = str(tmp_path / "base.avro")
    write_game_avro(base, data, maps)
    schema, records = avro_codec.read_container(base)
    schema["fields"].insert(1, {"name": "ts", "type": "double"})
    for i, rec in enumerate(records):
        rec["ts"] = 1e9 + i
    path = str(tmp_path / "with_ts.avro")
    avro_codec.write_container(path, schema, records)
    slots = []
    real = avro_native.decode_file

    def spy(fp, data_offset, sync, compiled):
        slots.append(set(compiled.dbl_slots))
        return real(fp, data_offset, sync, compiled)

    monkeypatch.setattr(avro_native, "decode_file", spy)
    got = read_game_avro(path, BAGS, COLS)
    assert slots == [{"response", "offset", "weight"}]
    _assert_same_read(got, jax_read_game_avro(path, BAGS, COLS))
    schema2 = copy.deepcopy(schema)
    schema2["fields"].append({"name": "meta", "type": {"type": "map", "values": "string"}})
    for rec in records:
        rec["meta"] = {"a": "b"}
    path2 = str(tmp_path / "with_map.avro")
    avro_codec.write_container(path2, schema2, records)
    got2 = read_game_avro(path2, BAGS, COLS)
    assert game_io.last_reader == "python" and len(slots) == 1
    _assert_same_read(got2, jax_read_game_avro(path2, BAGS, COLS))


def test_schema_compiler_matches_reference():
    from photon_tpu.native.avro_native import compile_schema as jax_compile

    base = {"type": "record", "name": "T", "fields": [
        {"name": "response", "type": "double"},
        {"name": "bag", "type": {"type": "array", "items": {
            "type": "record", "name": "FeatureAvro", "fields": [
                {"name": "name", "type": "string"}, {"name": "term", "type": "string"},
                {"name": "value", "type": "double"}]}}},
        {"name": "uid", "type": "string"},
        {"name": "offset", "type": ["null", "double"]},
    ]}
    variants = [base]
    for edit in (
        lambda s: s["fields"].append({"name": "meta", "type": {"type": "map",
                                                               "values": "string"}}),
        lambda s: s["fields"][2].update(type=["null", "string"]),
        lambda s: s["fields"][1]["type"]["items"]["fields"][2].update(type="float"),
    ):
        v = copy.deepcopy(base)
        edit(v)
        variants.append(v)
    for schema in variants:
        got = avro_native.compile_schema(schema, {"bag"}, {"uid"}, {"offset": 0.0})
        want = jax_compile(schema, {"bag"}, {"uid"}, {"offset": 0.0})
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.descriptor, got.dbl_slots, got.str_slots, got.bag_slots) == (
                want.descriptor, want.dbl_slots, want.str_slots, want.bag_slots)
    assert avro_native.compile_schema(variants[1], {"bag"}, {"uid"}) is None


def test_avro_glm_input_reads_natively(tmp_path):
    """The train driver's Avro input: one bag, the index map of the read."""
    from photon_tpu_torch.drivers import common

    data, maps = make_movielens_like(n_users=20, n_items=15, mean_ratings=5)
    path = str(tmp_path / "glm.avro")
    write_game_avro(path, data, maps)
    batch, dim, imap = common.load_dataset(path, True, "logistic_regression", "cpu",
                                           avro_field="global")
    assert common.input_reader(path) == "native"
    ref, _ = jax_read_game_avro(path, {"global": "global"}, [])
    np.testing.assert_array_equal(batch.ids.numpy(), ref.shard("global").ids)
    np.testing.assert_array_equal(batch.vals.numpy(), ref.shard("global").vals)
    assert dim == len(imap) == ref.shard("global").dim
    assert batch.label.dtype == torch.float32
