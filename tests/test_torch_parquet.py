"""The port's parquet codec against pyarrow (CPU).

Both directions, bit for bit: the port's files read by pyarrow (values and
dtypes), and what pyarrow writes (its defaults: SNAPPY, dictionary pages,
OPTIONAL columns; V2 data pages; the dictionary fallback to PLAIN; a
Spark-style directory of part files) read by the port. A null raises.
``load_processed_dataset`` over a directory the reference's ETL wrote
equals ``dct_tpu``'s. Inputs come from numpy seeds.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from dct_tpu_torch.etl import parquet


def _columns(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "d": rng.standard_normal(n),
        "f": rng.standard_normal(n).astype(np.float32),
        "i64": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
        # Few distinct values: pyarrow keeps the dictionary.
        "low": np.round(rng.standard_normal(n), 1),
        "label": rng.integers(0, 2, n).astype(np.int64),
    }


def _bit_equal(got: np.ndarray, want: np.ndarray) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                               np.ascontiguousarray(want).view(np.uint8)))


@pytest.mark.parametrize("n", [0, 1, 7, 5000])
def test_port_files_read_by_pyarrow_bit_equal(tmp_path, n):
    cols = _columns(n, n)
    path = str(tmp_path / "part-00000.parquet")
    assert parquet.write_table(path, cols) == path
    table = pq.read_table(path)
    assert table.column_names == list(cols)
    for name, want in cols.items():
        assert _bit_equal(table.column(name).to_numpy(), want), name
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == 1 and meta.num_rows == n
    col = meta.row_group(0).column(0)
    assert col.compression == "UNCOMPRESSED" and "PLAIN" in col.encodings
    schema = pq.ParquetFile(path).schema
    assert all(schema.column(i).max_definition_level == 0
               for i in range(len(cols)))  # REQUIRED
    # ... and by the port itself.
    got = parquet.read_table(path)
    assert list(got) == list(cols)
    for name, want in cols.items():
        assert _bit_equal(got[name], want), name
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


@pytest.mark.parametrize("kwargs", [
    {},  # pyarrow's defaults: SNAPPY, dictionary, OPTIONAL, V1 pages
    {"data_page_version": "2.0"},
    {"compression": "none"},
    {"use_dictionary": False},
    {"data_page_size": 512},  # many pages per column chunk
    {"dictionary_pagesize_limit": 256},  # dictionary then PLAIN fallback
    {"row_group_size": 700},
], ids=["defaults", "v2", "uncompressed", "plain", "small-pages",
        "dict-fallback", "row-groups"])
def test_pyarrow_files_read_by_port_bit_equal(tmp_path, kwargs):
    cols = _columns(3, 3000)
    path = str(tmp_path / "pa.parquet")
    pq.write_table(pa.table(cols), path, **kwargs)
    meta = pq.ParquetFile(path).metadata
    if not kwargs:
        c = meta.row_group(0).column(0)
        assert c.compression == "SNAPPY" and c.has_dictionary_page
        assert "RLE_DICTIONARY" in c.encodings
        assert pq.ParquetFile(path).schema.column(0).max_definition_level == 1
    got = parquet.read_table(path)
    assert list(got) == list(cols)
    for name, want in cols.items():
        assert _bit_equal(got[name], want), (kwargs, name)


def test_spark_style_directory_read_in_part_order(tmp_path):
    d = tmp_path / "data.parquet"
    d.mkdir()
    parts = [_columns(10 + i, 400 + 37 * i) for i in range(3)]
    # One part by pyarrow, one by the port, one by pyarrow with V2 pages.
    pq.write_table(pa.table(parts[0]), str(d / "part-00000.parquet"))
    parquet.write_table(str(d / "part-00001.parquet"), parts[1])
    pq.write_table(pa.table(parts[2]), str(d / "part-00002.parquet"),
                   data_page_version="2.0")
    (d / "_SUCCESS").write_text("")
    (d / "part-00003.parquet.tmp.99").write_text("a torn write")
    got = parquet.read_table(str(d))
    ref = pq.read_table(str(d / "part-00000.parquet"))  # schema order
    assert list(got) == ref.column_names
    for name in got:
        want = np.concatenate([p[name] for p in parts])
        assert _bit_equal(got[name], want), name
    assert parquet.part_files(str(d)) == [
        str(d / f"part-0000{i}.parquet") for i in range(3)]


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_a_null_raises(tmp_path, version):
    path = str(tmp_path / "nulls.parquet")
    pq.write_table(pa.table({"x": pa.array([1.0, None, 3.0])}), path,
                   data_page_version=version)
    with pytest.raises(parquet.ParquetError, match="null"):
        parquet.read_table(path)


def test_refusals_name_what_was_found(tmp_path):
    with pytest.raises(parquet.ParquetError, match="dtype"):
        parquet.write_table(str(tmp_path / "x.parquet"),
                            {"s": np.array(["a", "b"])})
    with pytest.raises(parquet.ParquetError, match="one length"):
        parquet.write_table(str(tmp_path / "x.parquet"),
                            {"a": np.zeros(2), "b": np.zeros(3)})
    path = str(tmp_path / "strings.parquet")
    pq.write_table(pa.table({"s": ["a", "b"]}), path)
    with pytest.raises(parquet.ParquetError, match="physical type"):
        parquet.read_table(path)
    path = str(tmp_path / "gzip.parquet")
    pq.write_table(pa.table({"x": [1.0, 2.0]}), path, compression="gzip")
    with pytest.raises(parquet.ParquetError, match="codec"):
        parquet.read_table(path)
    (tmp_path / "junk.parquet").write_bytes(b"not parquet at all")
    with pytest.raises(parquet.ParquetError, match="not a parquet file"):
        parquet.read_table(str(tmp_path / "junk.parquet"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(parquet.ParquetError, match="no parquet part"):
        parquet.read_table(str(tmp_path / "empty"))


def test_snappy_overlapping_copies_and_long_literals():
    # Literal "ab" (tag 0x04), then a 1-byte-offset copy of length 10 at
    # offset 2 (kind 1: length-4 in bits 2-4, offset high bits 5-7).
    block = bytes([12, 0x04]) + b"ab" + bytes([((10 - 4) << 2) | 1, 2])
    assert parquet.snappy_decompress(block) == b"ab" * 6
    # A 2-byte-offset copy of length 5 at offset 1 repeats one byte.
    block = bytes([6, 0x00]) + b"z" + bytes([((5 - 1) << 2) | 2, 1, 0])
    assert parquet.snappy_decompress(block) == b"z" * 6
    # A literal of 100 bytes needs the one-byte length form (60).
    payload = bytes(range(100))
    block = bytes([100, 60 << 2, 99]) + payload
    assert parquet.snappy_decompress(block) == payload
    with pytest.raises(parquet.ParquetError):
        parquet.snappy_decompress(bytes([4, ((4 - 4) << 2) | 1, 9]))


@pytest.mark.parametrize("bit_width", [0, 1, 3, 8, 13])
def test_rle_bitpacked_hybrid_matches_pyarrow_dictionary_indices(
        tmp_path, bit_width):
    # A dictionary of 2**bit_width values makes pyarrow write indices of
    # exactly that width; the port decodes them back to the column.
    n_dict = 1 << bit_width
    rng = np.random.default_rng(bit_width)
    values = rng.integers(0, n_dict, 2 * n_dict + 1000).astype(np.int64) * 3
    values[:n_dict] = np.arange(n_dict) * 3  # every entry present
    path = str(tmp_path / "idx.parquet")
    pq.write_table(pa.table({"v": values}), path,
                   dictionary_pagesize_limit=1 << 20)
    assert _bit_equal(parquet.read_table(path)["v"], values)


def test_load_processed_dataset_equals_reference_on_reference_etl(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DCT_LINEAGE", "0")
    from dct_tpu.data.dataset import load_processed_dataset as ref_load
    from dct_tpu.data.synthetic import append_weather_rows, generate_weather_csv
    from dct_tpu.etl.preprocess import preprocess_csv_to_parquet
    from dct_tpu_torch.data.dataset import load_processed_dataset

    csv = generate_weather_csv(str(tmp_path / "raw.csv"), rows=900, seed=4)
    out = str(tmp_path / "proc")
    preprocess_csv_to_parquet(csv, out)
    append_weather_rows(csv, rows=300, seed=5)
    preprocess_csv_to_parquet(csv, out)  # a delta part: two part files
    assert len(parquet.part_files(os.path.join(out, "data.parquet"))) == 2
    ref, got = ref_load(out), load_processed_dataset(out)
    assert got.feature_names == ref.feature_names
    assert _bit_equal(got.features, ref.features)
    assert _bit_equal(got.labels, ref.labels)


def test_etl_and_loader_run_where_pyarrow_cannot_be_imported(tmp_path):
    """The port needs no pyarrow: its ETL (full, then a delta) and
    ``load_processed_dataset`` run in a process where importing pyarrow
    fails."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'pyarrow':\n"
        "            raise ImportError('pyarrow is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from dct_tpu_torch.data.synthetic import (\n"
        "    append_weather_rows, generate_weather_csv)\n"
        "from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet\n"
        "from dct_tpu_torch.data.dataset import load_processed_dataset\n"
        f"d = {str(tmp_path)!r}\n"
        "csv = generate_weather_csv(d + '/raw.csv', rows=500, seed=1)\n"
        "preprocess_csv_to_parquet(csv, d + '/proc')\n"
        "append_weather_rows(csv, rows=100, seed=2)\n"
        "preprocess_csv_to_parquet(csv, d + '/proc')\n"
        "data = load_processed_dataset(d + '/proc')\n"
        "try:\n"
        "    import pyarrow\n"
        "    raise SystemExit('pyarrow imported')\n"
        "except ImportError:\n"
        "    pass\n"
        "assert 'pyarrow' not in sys.modules\n"
        "print(len(data), data.features.dtype, data.labels.dtype)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env["PYTHONPATH"] = repo
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["600", "float32", "int32"]
    want = pq.read_table(str(tmp_path / "proc" / "data.parquet"))
    assert want.num_rows == 600
