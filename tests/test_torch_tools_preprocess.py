"""The port's preprocessing tools against the JAX package's, on the CPU.

The same raw files and arrays go through both packages' converters
(in memory and chunked), the Spark converter's local stages, the random dataset
generators, the partition-offset files and the archive helpers; every file
written must be byte-identical. The port reads delimited text with the
standard library, so its reader is also held to pandas' strings on the
cases that differ between parsers (blank lines, quotes, CRLF, short rows, a
byte-order mark, a sniffed delimiter).
"""

import gzip
import os
import tarfile
import zipfile

import numpy as np
import pytest

from marius_tpu.tools.preprocess import chunked_converter as j_chunked
from marius_tpu.tools.preprocess import converter as j_converter
from marius_tpu.tools.preprocess import generate as j_generate
from marius_tpu.tools.preprocess import partitioner as j_partitioner
from marius_tpu.tools.preprocess import utils as j_utils
from marius_tpu_torch.tools import cli
from marius_tpu_torch.tools.preprocess import chunked_converter as t_chunked
from marius_tpu_torch.tools.preprocess import converter as t_converter
from marius_tpu_torch.tools.preprocess import generate as t_generate
from marius_tpu_torch.tools.preprocess import partitioner as t_partitioner
from marius_tpu_torch.tools.preprocess import utils as t_utils
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def write_raw_triples(path, n=200, nodes=40, rels=4, seed=0, delim="\t", weights=False,
                      prefix=("n", "r")):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            s, r, d = rng.integers(0, nodes), rng.integers(0, rels), rng.integers(0, nodes)
            row = [f"{prefix[0]}{s}", f"{prefix[1]}{r}", f"{prefix[0]}{d}"]
            if weights:
                row.append(f"{rng.random():.4f}")
            f.write(delim.join(row) + "\n")


def dir_files(d):
    out = {}
    for root, _, names in os.walk(d):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def assert_same_files(a, b):
    fa, fb = dir_files(a), dir_files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name


def assert_same_result(jr, tr):
    assert jr.stats == type(jr.stats)(**vars(tr.stats))
    for a, b in ((jr.node_mapping, tr.node_mapping), (jr.relation_mapping, tr.relation_mapping)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.astype(str), b.astype(str))


# -- the in-memory converter: each case of tests/test_tools.py:37-140,304-360 --

def _edges(seed, n, hi, cols):
    return np.random.default_rng(seed).integers(0, hi, (n, cols)).astype(np.int64)


def _deg_edges():
    rng = np.random.default_rng(1)
    hot = np.array([[7, 3]] * 30 + [[3, 11]] * 20 + [[11, 7]] * 10)
    return np.concatenate([hot, rng.integers(12, 40, (100, 2))]).astype(np.int64)


def _case(name, tmp):
    """(kwargs of EdgeListConverter without output_dir) for one case."""
    raw = str(tmp / "raw.tsv")
    two_col = dict(format="numpy", edge_type_column=None, dst_column=1, splits=(1.0,))
    if name == "remap_splits":
        write_raw_triples(raw)
        return dict(train_edges=raw, splits=(0.8, 0.1, 0.1))
    if name == "no_remap":
        return dict(train_edges=_edges(0, 100, 30, 3), format="numpy", remap_ids=False,
                    num_nodes=30, num_rels=30, splits=(1.0,))
    if name == "partitioned_eval":
        write_raw_triples(raw, n=400)
        return dict(train_edges=raw, splits=(0.8, 0.1, 0.1), num_partitions=4,
                    partitioned_evaluation=True)
    if name == "sequential_train_nodes":
        return dict(train_edges=_edges(0, 300, 50, 2), sequential_train_nodes=True,
                    known_node_ids=[np.arange(37, 50)], **two_col)
    if name == "sequential_deg_nodes":
        return dict(train_edges=_deg_edges(), sequential_deg_nodes=3, **two_col)
    if name == "train_and_deg_union":
        return dict(train_edges=_edges(2, 400, 30, 2), sequential_train_nodes=True,
                    sequential_deg_nodes=4, known_node_ids=[np.arange(25, 30)], **two_col)
    if name == "edge_weights":
        write_raw_triples(raw, n=100, nodes=20, rels=1, seed=5, weights=True)
        return dict(train_edges=raw, splits=(1.0,), edge_weight_column=3, num_partitions=2)
    if name == "weights_partitioned_no_remap":
        write_raw_triples(raw, n=200, nodes=40, rels=1, seed=7, weights=True, prefix=("", ""))
        return dict(train_edges=raw, splits=(0.7, 0.2), edge_weight_column=3,
                    num_partitions=4, remap_ids=False, num_nodes=40)
    if name == "single_relation":
        with open(raw, "w") as f:
            f.writelines(f"a{i}\tonly_rel\tb{i}\n" for i in range(30))
        return dict(train_edges=raw, splits=(1.0,))
    if name == "three_files":
        paths = []
        for i, n in enumerate((300, 30, 30)):
            paths.append(str(tmp / f"raw{i}.tsv"))
            write_raw_triples(paths[-1], n=n, seed=i)
        return dict(train_edges=paths[0], valid_edges=paths[1], test_edges=paths[2])
    if name == "numeric_ids_csv_header":
        with open(raw, "w") as f:
            f.write("src,rel,dst\n")
            rng = np.random.default_rng(3)
            for s, r, d in rng.integers(0, 60, (150, 3)):
                f.write(f'{s},"{r}",{d}\n')
        return dict(train_edges=raw, delim=",", header_length=1, splits=(0.9, 0.1))
    if name == "untyped_seeded":
        write_raw_triples(raw, n=300, seed=9)
        return dict(train_edges=raw, edge_type_column=None, dst_column=2, splits=(0.8, 0.1),
                    seed=11)
    raise KeyError(name)


CONVERTER_CASES = ("remap_splits", "no_remap", "partitioned_eval", "sequential_train_nodes",
                   "sequential_deg_nodes", "train_and_deg_union", "edge_weights",
                   "weights_partitioned_no_remap", "single_relation", "three_files",
                   "numeric_ids_csv_header", "untyped_seeded")


@pytest.mark.parametrize("case", CONVERTER_CASES)
def test_converter_writes_jax_files(tmp_path, case):
    kw = _case(case, tmp_path)
    jr = j_converter.EdgeListConverter(output_dir=str(tmp_path / "j"), **kw).convert()
    tr = t_converter.EdgeListConverter(output_dir=str(tmp_path / "t"), **kw).convert()
    assert_same_result(jr, tr)
    assert_same_files(tmp_path / "j", tmp_path / "t")


# -- the chunked converter (tests/test_tools.py:423-503) -----------------------

def _chunked_case(name, tmp):
    raw = str(tmp / "raw.tsv")
    if name == "remap_splits":
        write_raw_triples(raw, n=1000, nodes=80, rels=6)
        return dict(train_edges=raw, splits=(0.8, 0.1, 0.1), chunk_rows=64)
    if name == "partitioned_npy":
        src = str(tmp / "e.npy")
        np.save(src, _edges(3, 2000, 64, 3))
        return dict(train_edges=src, format="npy", remap_ids=False, num_nodes=64, num_rels=64,
                    splits=(1.0,), num_partitions=4, chunk_rows=128)
    if name == "three_files_partitioned_eval":
        paths = []
        for i, n in enumerate((500, 60, 60)):
            paths.append(str(tmp / f"raw{i}.tsv"))
            write_raw_triples(paths[-1], n=n, seed=i)
        return dict(train_edges=paths[0], valid_edges=paths[1], test_edges=paths[2],
                    num_partitions=2, partitioned_evaluation=True, chunk_rows=100)
    if name == "bin_no_remap_untyped":
        src = str(tmp / "e.bin")
        _edges(4, 300, 25, 2).astype(np.int32).tofile(src)
        return dict(train_edges=src, format="bin", remap_ids=False, edge_type_column=None,
                    dst_column=1, splits=(0.6, 0.2), chunk_rows=70)
    raise KeyError(name)


@pytest.mark.parametrize("case", ("remap_splits", "partitioned_npy",
                                  "three_files_partitioned_eval", "bin_no_remap_untyped"))
def test_chunked_converter_writes_jax_files(tmp_path, case):
    kw = _chunked_case(case, tmp_path)
    jr = j_chunked.ChunkedEdgeListConverter(output_dir=str(tmp_path / "j"), **kw).convert()
    tr = t_chunked.ChunkedEdgeListConverter(output_dir=str(tmp_path / "t"), **kw).convert()
    assert_same_result(jr, tr)
    assert_same_files(tmp_path / "j", tmp_path / "t")


def test_chunked_and_in_memory_write_the_same_files(tmp_path):
    """String ids and given train/valid/test files: both converters draw the
    node then the relation permutation, so every file is the same; the
    command line runs both (tools_cli in chip_smoke.py at full size)."""
    paths = []
    for i, n in enumerate((700, 80, 90)):
        paths.append(str(tmp_path / f"raw{i}.tsv"))
        write_raw_triples(paths[-1], n=n, nodes=120, rels=7, seed=i, prefix=("/m/0", "/rel/"))
    for out, extra in (("mem", []), ("chunked", ["--chunked", "--chunk_rows", "50"])):
        assert cli.main(["preprocess", "--edges", *paths,
                         "--output_directory", str(tmp_path / out), *extra], device="cpu") == 0
    assert_same_files(tmp_path / "mem", tmp_path / "chunked")


def test_preprocess_cli_matches_jax_cli(tmp_path):
    from marius_tpu.tools.cli import marius_preprocess as j_preprocess

    raw = str(tmp_path / "raw.tsv")
    write_raw_triples(raw)
    args = ["--edges", raw, "--dataset_split", "0.8", "0.1", "0.1", "--num_partitions", "4",
            "--sequential_deg_nodes", "5"]
    assert j_preprocess(args + ["--output_directory", str(tmp_path / "j")]) == 0
    assert cli.marius_preprocess(args + ["--output_directory", str(tmp_path / "t")]) == 0
    assert_same_files(tmp_path / "j", tmp_path / "t")
    sizes = t_partitioner.read_partition_offsets(
        str(tmp_path / "t" / "edges" / "train_partition_offsets.txt"))
    assert sizes.sum() == 160 and len(sizes) == 16


# -- the delimited reader against pandas' ---------------------------------------

READER_CASES = {
    "basic": "a\tb\tc\nd\te\tf\n",
    "blank_lines": "a\tb\tc\n\nd\te\tf\n\n",
    "whitespace_line": "a\tb\tc\n   \nd\te\tf\n",
    "empty_fields": "a\tb\tc\n\t\t\n\tb\tc\n",
    "crlf": "a\tb\tc\r\nd\te\tf\r\n",
    "cr": "a\tb\tc\rd\te\tf\r",
    "quotes": 'a\t"b c"\tc\n"d""x"\te\tf\na\tb"q\tc\n',
    "short_row": "a\tb\tc\nd\te\n",
    "trailing_delim": "a\tb\tc\t\nd\te\tf\t\n",
    "spaces_kept": " a \t b\tc \n",
    "bom": "﻿a\tb\tc\n",
    "no_final_newline": "a\tb\tc\nd\te\tf",
    "na_strings": "NA\tnull\tnan\n#x\tNone\t-\n",
}


def _pandas_read(path, sep, header_length, **kw):
    pd = pytest.importorskip("pandas")
    return pd.read_csv(path, sep=sep, header=None, skiprows=header_length, dtype=str,
                       keep_default_na=False, **kw).to_numpy()


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_delimited_reader_gives_pandas_strings(tmp_path, case):
    path = tmp_path / "in.txt"
    path.write_bytes(READER_CASES[case].encode())
    want = _pandas_read(path, "\t", 0)
    got = next(t_converter.read_delimited(path, "\t", 0, range(want.shape[1])))
    assert got.tolist() == want.tolist()
    chunks = list(t_converter.read_delimited(path, "\t", 0, range(want.shape[1]), 1))
    assert np.concatenate(chunks).tolist() == want.tolist()


@pytest.mark.parametrize("text,sep,skip", [
    ("h1\nh2\na,b,c\nd,e,f\n", ",", 2),
    ("h\n\na b c\n", " ", 2),
    ("x;y;z\n1;2;3\n", None, 0),
    ("/m/01\t/r/1\t/m/02\n/m/03\t/r/2\t/m/04\n", None, 0),
    ("u1,follows,u2\nu2,follows,u3\n", None, 0),
])
def test_delimited_reader_skips_and_sniffs_as_pandas(tmp_path, text, sep, skip):
    path = tmp_path / "in.txt"
    path.write_text(text)
    kw = {"engine": "python"} if sep is None else {}
    want = _pandas_read(path, sep, skip, **kw)
    got = next(t_converter.read_delimited(path, sep, skip, range(want.shape[1])))
    assert got.tolist() == want.tolist()


def test_delimited_reader_refuses_what_pandas_refuses(tmp_path):
    pd = pytest.importorskip("pandas")
    for text in ("a\tb\tc\nd\te\tf\tg\n", "a\tb\nd\te\tf\n"):
        path = tmp_path / "in.txt"
        path.write_text(text)
        with pytest.raises(pd.errors.ParserError):
            _pandas_read(path, "\t", 0)
        with pytest.raises(ValueError, match="expected 2 fields|expected 3 fields"):
            next(t_converter.read_delimited(path, "\t", 0, [0]))
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    with pytest.raises(ValueError, match="no rows"):
        next(t_converter.read_delimited(empty, "\t", 0, [0]))


# -- generators, offsets, archives -------------------------------------------

@pytest.mark.parametrize("task", ["lp", "nc"])
def test_random_datasets_match_jax(tmp_path, task):
    fn = f"generate_random_dataset_{task}"
    kw = dict(num_nodes=57, num_edges=433, seed=4)
    js = getattr(j_generate, fn)(str(tmp_path / "j"), **kw)
    ts = getattr(t_generate, fn)(str(tmp_path / "t"), **kw)
    assert vars(js) == vars(ts)
    assert_same_files(tmp_path / "j", tmp_path / "t")


def test_partition_offsets_round_trip_as_jax(tmp_path):
    sizes = np.random.default_rng(0).integers(0, 1000, 16)
    j_partitioner.write_partition_offsets(str(tmp_path / "j.txt"), sizes)
    t_partitioner.write_partition_offsets(str(tmp_path / "t.txt"), sizes)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    np.testing.assert_array_equal(t_partitioner.read_partition_offsets(str(tmp_path / "j.txt")),
                                  j_partitioner.read_partition_offsets(str(tmp_path / "t.txt")))


@pytest.mark.parametrize("kind", ["zip", "tar.gz", "gz"])
def test_extract_file_matches_jax(tmp_path, kind):
    payload = b"a\tb\tc\n" * 10
    for who, utils in (("j", j_utils), ("t", t_utils)):
        d = tmp_path / who
        d.mkdir()
        (d / "src").mkdir()
        (d / "src" / "train.txt").write_bytes(payload)
        archive = d / f"data.{kind}"
        if kind == "zip":
            with zipfile.ZipFile(archive, "w") as z:
                z.write(d / "src" / "train.txt", "inner/train.txt")
        elif kind == "tar.gz":
            with tarfile.open(archive, "w:gz") as t:
                t.add(d / "src" / "train.txt", "inner/train.txt")
        else:
            with gzip.open(archive, "wb") as g:
                g.write(payload)
        (d / "src" / "train.txt").unlink()
        (d / "src").rmdir()
        assert utils.extract_file(archive) == d
        assert not archive.exists()
    assert_same_files(tmp_path / "j", tmp_path / "t")


def test_download_url_returns_a_placed_file_without_the_network(tmp_path):
    placed = tmp_path / "FB15K-237.2.zip"
    placed.write_bytes(b"x")
    url = "https://example.invalid/FB15K-237.2.zip"
    assert t_utils.download_url(url, tmp_path) == j_utils.download_url(url, tmp_path) == placed


# -- the Spark converter's local stages (tests/test_spark_stages.py:48-139) ------

def _write_parts(directory, frames, columns):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    os.makedirs(directory, exist_ok=True)
    for i, arr in enumerate(frames):
        t = pa.table({c: arr[:, j] for j, c in enumerate(columns)})
        pq.write_table(t, os.path.join(directory, f"part-{i:05d}-deadbeef.parquet"))


def _bucket_sorted_frames(edges, num_partitions, part_size, n_parts):
    keys = (edges[:, 0] // part_size) * num_partitions + edges[:, -1] // part_size
    s = edges[np.argsort(keys, kind="stable")]
    cuts = np.linspace(0, len(s), n_parts + 1).astype(int)
    return [s[cuts[i]:cuts[i + 1]] for i in range(n_parts)]


def test_spark_bucketed_assembly_matches_jax_and_the_chunked_partitioner(tmp_path):
    from marius_tpu.tools.preprocess import spark_stages as jst
    from marius_tpu_torch.tools.preprocess import spark_stages as tst

    rng = np.random.default_rng(0)
    n, r, e, P = 100, 5, 2000, 4
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, r, e),
                      rng.integers(0, n, e)], 1).astype(np.int32)
    part_size = -(-n // P)
    cols = [tst.SRC, tst.REL, tst.DST]
    _write_parts(tmp_path / "parts", _bucket_sorted_frames(edges, P, part_size, 7), cols)
    parts = tst.parquet_parts_in_order(str(tmp_path / "parts"))
    assert parts == jst.parquet_parts_in_order(str(tmp_path / "parts"))
    for who, st in (("j", jst), ("t", tst)):
        (tmp_path / who).mkdir()
        cnt, counts = st.stream_parts_to_bucketed_binary(
            parts, str(tmp_path / who / "train_edges.bin"), cols, P, part_size,
            offsets_path=str(tmp_path / who / "train_partition_offsets.txt"))
        assert cnt == e
    assert_same_files(tmp_path / "j", tmp_path / "t")

    # the same bucket layout as the chunked converter's out-of-core partitioner
    ref_bin = tmp_path / "ref.bin"
    edges.tofile(ref_bin)
    conv = t_chunked.ChunkedEdgeListConverter.__new__(t_chunked.ChunkedEdgeListConverter)
    conv.num_partitions, conv.has_rels, conv.chunk_rows = P, True, 333
    conv._partition_file(str(ref_bin), e, n, str(tmp_path), "ref")
    got = np.fromfile(tmp_path / "t" / "train_edges.bin", np.int32).reshape(e, 3)
    ref = np.fromfile(ref_bin, np.int32).reshape(e, 3)
    np.testing.assert_array_equal(
        counts, t_partitioner.read_partition_offsets(str(tmp_path / "ref_partition_offsets.txt")))
    starts = np.concatenate([[0], np.cumsum(counts)])
    for b in range(P * P):
        assert (sorted(map(tuple, got[starts[b]:starts[b + 1]]))
                == sorted(map(tuple, ref[starts[b]:starts[b + 1]])))


def test_spark_stages_plain_stream_mapping_and_refusals(tmp_path):
    from marius_tpu.tools.preprocess import spark_stages as jst
    from marius_tpu_torch.tools.preprocess import spark_stages as tst

    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(2)
    edges = np.stack([rng.integers(0, 50, 700), rng.integers(0, 3, 700),
                      rng.integers(0, 50, 700)], 1).astype(np.int32)
    _write_parts(tmp_path / "parts", [edges[:100], edges[100:400], edges[400:]],
                 [tst.SRC, tst.REL, tst.DST])
    (tmp_path / "map").mkdir()
    pq.write_table(pa.table({"node_label": np.array(["/m/0abc", "/m/0def", "/m/0ghi"]),
                             "node_id": np.array([2, 0, 1], np.int64)}),
                   str(tmp_path / "map" / "part-00000.parquet"))
    unsorted = np.stack([rng.integers(0, 40, 500), rng.integers(0, 40, 500)], 1).astype(np.int32)
    _write_parts(tmp_path / "unsorted", [unsorted[:250], unsorted[250:]], [tst.SRC, tst.DST])
    for who, st in (("j", jst), ("t", tst)):
        (tmp_path / who).mkdir()
        assert st.stream_parts_to_binary(st.parquet_parts_in_order(str(tmp_path / "parts")),
                                         str(tmp_path / who / "e.bin"),
                                         [st.SRC, st.REL, st.DST]) == 700
        assert st.stream_mapping_to_txt(st.parquet_parts_in_order(str(tmp_path / "map")),
                                        str(tmp_path / who / "node_mapping.txt"),
                                        "node_label", "node_id") == 3
        with pytest.raises(ValueError, match="not bucket-sorted"):
            st.stream_parts_to_bucketed_binary(
                st.parquet_parts_in_order(str(tmp_path / "unsorted")),
                str(tmp_path / "o.bin"), [st.SRC, st.DST], 4, 10)
    assert_same_files(tmp_path / "j", tmp_path / "t")
    np.testing.assert_array_equal(np.fromfile(tmp_path / "t" / "e.bin", np.int32).reshape(-1, 3),
                                  edges)
    assert (tmp_path / "t" / "node_mapping.txt").read_text() == "/m/0abc,2\n/m/0def,0\n/m/0ghi,1\n"


def test_spark_converter_requires_pyspark_as_jax():
    from marius_tpu.tools.preprocess.spark_converter import SparkEdgeListConverter as J
    from marius_tpu_torch.tools.preprocess.spark_converter import SparkEdgeListConverter as T

    try:
        import pyspark  # noqa: F401
        pytest.skip("pyspark installed; the refusal is not reachable")
    except ImportError:
        pass
    for cls in (J, T):
        with pytest.raises(RuntimeError, match="requires pyspark"):
            cls(output_dir="unused", train_edges="unused")
