"""Export trained embeddings/model with inverse id mapping.

Parity with marius_postprocess (tools/marius_postprocess.py +
tools/postprocess/in_memory_exporter.py:61 export_node_embeddings): read the
saved table from model_dir, apply the inverse node-id mapping if the dataset
was remapped, and write CSV / parquet / binary. A copy of
``marius_tpu/tools/postprocess.py``: it reads the ``table__values.npy`` the
port's checkpoints write in the JAX package's layout and writes the same
files from it. Parquet needs pandas.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def export_node_embeddings(
    model_dir: str,
    output_dir: str,
    fmt: str = "csv",
    dataset_dir: Optional[str] = None,
    delim: str = ",",
) -> str:
    emb_path = os.path.join(model_dir, "table__values.npy")
    if not os.path.exists(emb_path):
        raise FileNotFoundError(f"no embedding table found at {emb_path}")
    embeddings = np.load(emb_path)

    ids = np.arange(len(embeddings))
    raw_ids = ids.astype(str)
    mapping_file = (os.path.join(dataset_dir, "nodes", "node_mapping.txt")
                    if dataset_dir else None)
    if mapping_file and os.path.exists(mapping_file):
        mapping = np.genfromtxt(mapping_file, delimiter=",", dtype=str)
        raw = mapping[:, 0]
        new = mapping[:, 1].astype(np.int64)
        inv = np.empty(len(embeddings), dtype=raw.dtype)
        inv[new] = raw
        raw_ids = inv

    os.makedirs(output_dir, exist_ok=True)
    fmt = fmt.lower()
    if fmt == "csv":
        out = os.path.join(output_dir, "embeddings.csv")
        with open(out, "w") as f:
            for rid, row in zip(raw_ids, embeddings):
                f.write(rid + delim + delim.join(f"{x:.6f}" for x in row) + "\n")
    elif fmt == "parquet":
        import pandas as pd
        out = os.path.join(output_dir, "embeddings.parquet")
        df = pd.DataFrame(embeddings)
        df.insert(0, "id", raw_ids)
        df.to_parquet(out)
    elif fmt in ("bin", "binary"):
        out = os.path.join(output_dir, "embeddings.bin")
        embeddings.astype(np.float32).tofile(out)
    else:
        raise ValueError(f"Unknown format: {fmt}")
    return out
