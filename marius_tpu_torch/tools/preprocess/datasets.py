"""Built-in dataset catalog: download + preprocess into the binary layout.

Parity with the reference's 15 dataset preprocessors (tools/preprocess/
datasets/*: fb15k, fb15k_237, freebase86m, livejournal, twitter, friendster,
ogbl_{ppa,collab,citation2,wikikg2}, ogbn_{arxiv,products,papers100m},
ogb_{mag240m,wikikg90mv2}) and base classes (tools/preprocess/dataset.py:
53-79). Each dataset knows its source URL, archive layout, and column spec;
`download()` fetches and unpacks raw files, `preprocess()` runs the
EdgeListConverter and (for NC datasets) writes remapped features/labels/splits.
A copy of ``marius_tpu/tools/preprocess/datasets.py`` over the port's
converter: the same raw files give the same dataset files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Type

import numpy as np

from marius_tpu_torch.storage.dataset import save_node_array, save_stats
from marius_tpu_torch.tools.preprocess.converter import EdgeListConverter
from marius_tpu_torch.tools.preprocess.utils import download_url, extract_file


class Dataset:
    dataset_name: str = ""
    dataset_url: str = ""

    def __init__(self, output_directory):
        self.output_directory = Path(output_directory)
        self.output_directory.mkdir(parents=True, exist_ok=True)

    def download(self, overwrite: bool = False) -> None:
        raise NotImplementedError

    def preprocess(self, num_partitions: int = 1, remap_ids: bool = True,
                   splits=None, sequential_train_nodes: bool = False,
                   partitioned_eval: bool = False):
        raise NotImplementedError


class LinkPredictionDataset(Dataset):
    pass


class NodeClassificationDataset(Dataset):
    pass


# ---------------------------------------------------------------------------
# Delimited-triple LP datasets (download -> train/valid/test txt files)
# ---------------------------------------------------------------------------


class _TripleFileDataset(LinkPredictionDataset):
    """LP dataset distributed as delimited (src, rel, dst) triple files."""

    delim = "\t"
    src_column = 0
    edge_type_column: Optional[int] = 1
    dst_column = 2
    train_name = "train.txt"
    valid_name: Optional[str] = "valid.txt"
    test_name: Optional[str] = "test.txt"
    default_splits = None

    def download(self, overwrite=False):
        self.input_train = self.output_directory / self.train_name
        self.input_valid = (self.output_directory / self.valid_name
                            if self.valid_name else None)
        self.input_test = (self.output_directory / self.test_name
                           if self.test_name else None)
        needed = [self.input_train] + [p for p in (self.input_valid, self.input_test) if p]
        if all(p.exists() for p in needed) and not overwrite:
            return
        archive = download_url(self.dataset_url, self.output_directory, overwrite)
        extract_file(archive, remove_input=True)
        self._post_extract()

    def _post_extract(self):
        pass

    def preprocess(self, num_partitions=1, remap_ids=True, splits=None,
                   sequential_train_nodes=False, partitioned_eval=False):
        return EdgeListConverter(
            output_dir=str(self.output_directory),
            train_edges=str(self.input_train),
            valid_edges=str(self.input_valid) if self.input_valid else None,
            test_edges=str(self.input_test) if self.input_test else None,
            splits=splits or self.default_splits,
            delim=self.delim,
            src_column=self.src_column,
            dst_column=self.dst_column,
            edge_type_column=self.edge_type_column,
            remap_ids=remap_ids,
            num_partitions=num_partitions,
            partitioned_evaluation=partitioned_eval,
        ).convert()


class FB15K(_TripleFileDataset):
    """Freebase 15k (fb15k.py:20-57)."""

    dataset_name = "fb15k"
    dataset_url = "https://dl.fbaipublicfiles.com/starspace/fb15k.tgz"
    train_name = "freebase_mtr100_mte100-train.txt"
    valid_name = "freebase_mtr100_mte100-valid.txt"
    test_name = "freebase_mtr100_mte100-test.txt"

    def _post_extract(self):
        sub = self.output_directory / "FB15k"
        if sub.exists():
            for f in sub.iterdir():
                f.rename(self.output_directory / f.name)
            sub.rmdir()


class FB15K237(_TripleFileDataset):
    """Freebase 15k-237 (fb15k_237.py:8-64)."""

    dataset_name = "fb15k_237"
    dataset_url = "https://data.deepai.org/FB15K-237.2.zip"

    def _post_extract(self):
        sub = self.output_directory / "Release"
        if sub.exists():
            for f in sub.iterdir():
                f.rename(self.output_directory / f.name)
            sub.rmdir()


class Freebase86m(_TripleFileDataset):
    """Freebase 86m (freebase86m.py:18-54): columns are [src, dst, rel]."""

    dataset_name = "freebase86m"
    dataset_url = "https://data.dgl.ai/dataset/Freebase.zip"
    src_column = 0
    dst_column = 1
    edge_type_column = 2
    train_name = "train.txt"

    def _post_extract(self):
        sub = self.output_directory / "Freebase"
        if sub.exists():
            for f in sub.iterdir():
                f.rename(self.output_directory / f.name)
            sub.rmdir()


class LiveJournal(_TripleFileDataset):
    """soc-LiveJournal1 (livejournal.py:23-50): unlabeled edges, 90/5/5 split."""

    dataset_name = "livejournal"
    dataset_url = "https://snap.stanford.edu/data/soc-LiveJournal1.txt.gz"
    edge_type_column = None
    dst_column = 1
    train_name = "soc-LiveJournal1.txt"
    valid_name = None
    test_name = None
    default_splits = (0.9, 0.05, 0.05)


class Twitter(_TripleFileDataset):
    """twitter-2010 (twitter.py:21-46)."""

    dataset_name = "twitter"
    dataset_url = "https://snap.stanford.edu/data/twitter-2010.txt.gz"
    delim = " "
    edge_type_column = None
    dst_column = 1
    train_name = "twitter-2010.txt"
    valid_name = None
    test_name = None
    default_splits = (0.9, 0.05, 0.05)


class Friendster(_TripleFileDataset):
    """com-friendster (friendster.py:24-55)."""

    dataset_name = "friendster"
    dataset_url = "https://snap.stanford.edu/data/bigdata/communities/com-friendster.ungraph.txt.gz"
    edge_type_column = None
    dst_column = 1
    train_name = "com-friendster.ungraph.txt"
    valid_name = None
    test_name = None
    default_splits = (0.9, 0.05, 0.05)


# ---------------------------------------------------------------------------
# OGB link-prediction datasets (zip with split/target/*.pt or csv.gz files)
# ---------------------------------------------------------------------------


class _OGBLDataset(LinkPredictionDataset):
    """ogbl_* zips: raw csv.gz triples under <name>/raw/, splits precomputed
    (ogbl_ppa.py / ogbl_citation2.py / ogbl_wikikg2.py / ogbl_collab.py)."""

    archive_subdir = ""
    has_rels = False

    def download(self, overwrite=False):
        self.raw_dir = self.output_directory / self.archive_subdir
        if self.raw_dir.exists() and not overwrite:
            return
        archive = download_url(self.dataset_url, self.output_directory, overwrite)
        extract_file(archive, remove_input=True)

    def _load_split_edges(self, split: str) -> np.ndarray:
        """Load one split as an int array of [src(,rel),dst] rows. Prefers
        numpy .npz/.csv files; falls back to torch .pt archives."""
        split_dir = next((self.raw_dir / "split").iterdir())
        pt = split_dir / f"{split}.pt"
        if pt.exists():
            import torch
            d = torch.load(pt, map_location="cpu", weights_only=False)
            if isinstance(d, dict):
                if "head" in d:  # wikikg2-style
                    cols = [np.asarray(d["head"]), np.asarray(d["relation"]),
                            np.asarray(d["tail"])]
                    return np.stack(cols, axis=1)
                edge = np.asarray(d.get("edge", d.get("source_node")))
                if edge.ndim == 1:  # citation2-style source/target vectors
                    return np.stack([np.asarray(d["source_node"]),
                                     np.asarray(d["target_node"])], axis=1)
                return edge
            return np.asarray(d)
        raise FileNotFoundError(pt)

    def preprocess(self, num_partitions=1, remap_ids=True, splits=None,
                   sequential_train_nodes=False, partitioned_eval=False):
        train = self._load_split_edges("train").astype(np.int64)
        valid = self._load_split_edges("valid").astype(np.int64)
        test = self._load_split_edges("test").astype(np.int64)
        ncols = train.shape[1]
        return EdgeListConverter(
            output_dir=str(self.output_directory),
            train_edges=train, valid_edges=valid, test_edges=test,
            format="numpy",
            src_column=0,
            dst_column=ncols - 1,
            edge_type_column=1 if ncols == 3 else None,
            remap_ids=remap_ids,
            num_partitions=num_partitions,
            partitioned_evaluation=partitioned_eval,
        ).convert()


class OGBLPpa(_OGBLDataset):
    dataset_name = "ogbl_ppa"
    dataset_url = "http://snap.stanford.edu/ogb/data/linkproppred/ppassoc.zip"
    archive_subdir = "ppassoc"


class OGBLCollab(_OGBLDataset):
    dataset_name = "ogbl_collab"
    dataset_url = "http://snap.stanford.edu/ogb/data/linkproppred/collab.zip"
    archive_subdir = "collab"


class OGBLCitation2(_OGBLDataset):
    dataset_name = "ogbl_citation2"
    dataset_url = "http://snap.stanford.edu/ogb/data/linkproppred/citation-v2.zip"
    archive_subdir = "citation-v2"


class OGBLWikiKG2(_OGBLDataset):
    dataset_name = "ogbl_wikikg2"
    dataset_url = "http://snap.stanford.edu/ogb/data/linkproppred/wikikg-v2.zip"
    archive_subdir = "wikikg-v2"
    has_rels = True


# ---------------------------------------------------------------------------
# OGB node-classification datasets
# ---------------------------------------------------------------------------


class _OGBNDataset(NodeClassificationDataset):
    """ogbn_* zips: edge.csv + node-feat.csv + node-label.csv + split csvs
    (ogbn_arxiv.py:13-120, ogbn_products.py, ogbn_papers100m.py)."""

    archive_subdir = ""
    num_classes = -1
    feature_delim = ","

    def download(self, overwrite=False):
        self.input_edges = self.output_directory / "edge.csv"
        self.input_features = self.output_directory / "node-feat.csv"
        self.input_labels = self.output_directory / "node-label.csv"
        self.split_files = {s: self.output_directory / f"{s}.csv"
                            for s in ("train", "valid", "test")}
        needed = [self.input_edges, self.input_features, self.input_labels,
                  *self.split_files.values()]
        if all(p.exists() for p in needed) and not overwrite:
            return
        sub = self.output_directory / self.archive_subdir
        # zero-egress path: a pre-placed OGB raw layout (<subdir>/raw/*.csv
        # or *.csv.gz + <subdir>/split/...) skips the download entirely;
        # download_url itself short-circuits on a pre-placed archive file
        if not (sub / "raw").exists():
            archive = download_url(self.dataset_url, self.output_directory,
                                    overwrite)
            extract_file(archive, remove_input=False)
        for name, dest in [("edge.csv", self.input_edges),
                           ("node-feat.csv", self.input_features),
                           ("node-label.csv", self.input_labels)]:
            src = sub / "raw" / name
            if not src.exists():
                extract_file(sub / "raw" / (name + ".gz"), remove_input=False)
            src.rename(dest)
        split_dir = next((sub / "split").iterdir())
        for s, dest in self.split_files.items():
            gz = split_dir / f"{s}.csv.gz"
            if gz.exists():
                extract_file(gz, remove_input=False)
            (split_dir / f"{s}.csv").rename(dest)

    def preprocess(self, num_partitions=1, remap_ids=True, splits=None,
                   sequential_train_nodes=False, partitioned_eval=False):
        node_splits = {s: np.loadtxt(p, delimiter=",", dtype=np.int64)
                       for s, p in self.split_files.items()}
        result = EdgeListConverter(
            output_dir=str(self.output_directory),
            train_edges=str(self.input_edges),
            delim=",",
            src_column=0,
            dst_column=1,
            edge_type_column=None,
            remap_ids=remap_ids,
            sequential_train_nodes=sequential_train_nodes,
            known_node_ids=list(node_splits.values()),
            num_partitions=num_partitions,
            partitioned_evaluation=partitioned_eval,
        ).convert()

        features = np.loadtxt(self.input_features, delimiter=self.feature_delim,
                              dtype=np.float32)
        labels = np.loadtxt(self.input_labels, delimiter=",").astype(np.int32)

        if remap_ids:
            node_splits, features, labels = remap_node_data(
                result.node_mapping, node_splits, features, labels)

        out = str(self.output_directory)
        save_node_array(out, "features", features)
        save_node_array(out, "labels", labels)
        save_node_array(out, "train_nodes", node_splits["train"].astype(np.int32))
        save_node_array(out, "valid_nodes", node_splits["valid"].astype(np.int32))
        save_node_array(out, "test_nodes", node_splits["test"].astype(np.int32))

        stats = result.stats
        stats.num_train = len(node_splits["train"])
        stats.num_valid = len(node_splits["valid"])
        stats.num_test = len(node_splits["test"])
        stats.feature_dim = features.shape[1]
        stats.num_classes = self.num_classes
        save_stats(out, stats)
        return result


class OGBNArxiv(_OGBNDataset):
    dataset_name = "ogbn_arxiv"
    dataset_url = "http://snap.stanford.edu/ogb/data/nodeproppred/arxiv.zip"
    archive_subdir = "arxiv"
    num_classes = 40


class OGBNProducts(_OGBNDataset):
    dataset_name = "ogbn_products"
    dataset_url = "http://snap.stanford.edu/ogb/data/nodeproppred/products.zip"
    archive_subdir = "products"
    num_classes = 47


class OGBNPapers100M(_OGBNDataset):
    dataset_name = "ogbn_papers100m"
    dataset_url = "http://snap.stanford.edu/ogb/data/nodeproppred/papers100M-bin.zip"
    archive_subdir = "papers100M-bin"
    num_classes = 172


class OGBMag240M(_OGBNDataset):
    dataset_name = "ogb_mag240m"
    dataset_url = "https://dgl-data.s3-accelerate.amazonaws.com/dataset/OGB-LSC/mag240m_kddcup2021.zip"
    archive_subdir = "mag240m_kddcup2021"
    num_classes = 153


class OGBWikiKG90Mv2(_OGBLDataset):
    dataset_name = "ogb_wikikg90mv2"
    dataset_url = "https://dgl-data.s3-accelerate.amazonaws.com/dataset/OGB-LSC/wikikg90m-v2.zip"
    archive_subdir = "wikikg90m-v2"
    has_rels = True


def remap_node_data(node_mapping: np.ndarray, node_splits: Dict[str, np.ndarray],
                    features: np.ndarray, labels: np.ndarray):
    """Apply a raw->new node-id mapping to node splits and reorder per-node
    feature/label rows (dataset_helpers.py remap_nodes)."""
    raw = node_mapping[:, 0].astype(np.int64)
    new = node_mapping[:, 1].astype(np.int64)
    order = np.argsort(raw)
    raw, new = raw[order], new[order]

    def map_ids(ids):
        return new[np.searchsorted(raw, np.asarray(ids, np.int64))]

    remapped_splits = {s: map_ids(v) for s, v in node_splits.items()}
    n = len(raw)
    feat_out = np.zeros((n, features.shape[1]), features.dtype)
    feat_out[new] = features[raw]
    lab_out = np.zeros(n, labels.dtype)
    lab_out[new] = labels[raw]
    return remapped_splits, feat_out, lab_out


DATASET_REGISTRY: Dict[str, Type[Dataset]] = {
    d.dataset_name: d for d in [
        FB15K, FB15K237, Freebase86m, LiveJournal, Twitter, Friendster,
        OGBLPpa, OGBLCollab, OGBLCitation2, OGBLWikiKG2,
        OGBNArxiv, OGBNProducts, OGBNPapers100M, OGBMag240M, OGBWikiKG90Mv2,
    ]
}
