"""Download and extract helpers.

A copy of ``marius_tpu/tools/preprocess/utils.py`` (reference
tools/preprocess/utils.py): ``download_url`` fetches with urllib and returns
a file already in place without touching the network; ``extract_file``
unpacks .zip, .tar(.gz), .tgz and .gz archives beside themselves.
"""

from __future__ import annotations

import gzip
import shutil
import tarfile
import urllib.request
import zipfile
from pathlib import Path


def download_url(url: str, output_dir, overwrite: bool = False) -> Path:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    filename = url.rsplit("/", 1)[-1]
    filepath = output_dir / filename
    if filepath.exists() and not overwrite:
        return filepath
    try:
        urllib.request.urlretrieve(url, str(filepath))
    except Exception as e:  # zero-egress environments: explain instead of a raw URLError
        raise RuntimeError(
            f"Could not download {url}: {e}. If this machine has no internet "
            f"access, place the file manually at {filepath} and rerun.") from e
    return filepath


def extract_file(filepath, remove_input: bool = True) -> Path:
    """Extract .zip/.tar(.gz)/.gz into the file's directory; returns the dir."""
    filepath = Path(filepath)
    directory = filepath.parent
    name = filepath.name
    if name.endswith(".zip"):
        with zipfile.ZipFile(filepath) as z:
            z.extractall(directory)
    elif name.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(filepath) as t:
            t.extractall(directory)
    elif name.endswith(".gz"):
        out = directory / name[:-3]
        with gzip.open(filepath, "rb") as fin, open(out, "wb") as fout:
            shutil.copyfileobj(fin, fout)
    else:
        raise ValueError(f"Unknown archive format: {name}")
    if remove_input:
        filepath.unlink()
    return directory
