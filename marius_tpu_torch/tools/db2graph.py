"""Extract an edge list from a SQL database.

Parity with marius_db2graph (tools/db2graph/marius_db2graph.py:419). Two
query styles are supported:

- **Free-form** (``edge_queries``): each SQL query returns (src, rel, dst)
  or (src, dst) rows written verbatim — the simple mode this tool always
  had, kept for sqlite-based workflows.
- **Entity-entity** (``edges_queries`` — the reference's mode,
  marius_db2graph.py:173 validation_check / :295 post_processing): each
  query is ``SELECT t1.c1, t2.c2 FROM ...`` paired with a relation NAME;
  rows are streamed in adaptively-sized batches (fetchmany; the fetch size
  grows toward half the machine's free memory after a measured first batch,
  :243 get_fetch_size), tokens cleaned (strip/lower, :232 clean_token),
  invalid entries dropped (INVALID_ENTRY_LIST), per-batch duplicates
  removed, and node ids uniquified as ``table_column_value`` so ids from
  different tables never collide.

Config accepts BOTH this tool's spelling (db_type/connection/edge_queries)
and the reference's (db_server/db_name/db_user/db_password/db_host +
``edges_queries: path`` to a file of alternating relation-name/query lines).
Supports sqlite (stdlib) out of the box; mysql/postgres if their client libraries
are installed — postgres uses a server-side named cursor so the database,
not the client, holds the result set (psycopg usage.html#server-side-cursors).
A copy of ``marius_tpu/tools/db2graph.py`` (standard library and yaml only).
"""

from __future__ import annotations

import os
import re
from typing import Iterable, List, Sequence, Tuple

import yaml

INVALID_ENTRIES = {"0", None, "", 0, "not reported", "none"}
FETCH_SIZE = 10_000
MAX_FETCH_SIZE = 1_000_000_000


def _connect(db_type: str, **kwargs):
    db_type = db_type.lower()
    if db_type == "sqlite":
        import sqlite3
        return sqlite3.connect(kwargs["database"])
    if db_type in ("mysql", "mariadb", "maria-db", "my-sql"):
        try:
            import mysql.connector
        except ImportError as e:
            raise RuntimeError("mysql-connector-python is not installed") from e
        return mysql.connector.connect(**kwargs)
    if db_type in ("postgres", "postgresql", "psql", "postgre-sql"):
        try:
            import psycopg2
        except ImportError as e:
            raise RuntimeError("psycopg2 is not installed") from e
        return psycopg2.connect(**kwargs)
    raise ValueError(f"Unknown db_type: {db_type}")


def _cursor(conn, db_type: str, name: str):
    """Server-side (named) cursor on postgres so large result sets stream
    from the server; client-side elsewhere."""
    if db_type.lower() in ("postgres", "postgresql", "psql", "postgre-sql"):
        return conn.cursor(name=name)
    return conn.cursor()


def validate_entity_entity_query(query: str) -> Tuple[str, str, str, str]:
    """Enforce the reference's query contract
    (validation_check_edge_entity_entity_queries, marius_db2graph.py:173):
    ``SELECT table1.col1, table2.col2 FROM ...``, no AS aliases (the
    table_column id prefixes come from the literal spelling). Returns
    (table1, col1, table2, col2)."""
    parts = query.strip().split()
    if len(parts) < 4:
        raise ValueError(f"query too short to be entity-entity: {query!r}")
    if any(p.lower() == "as" for p in parts):
        raise ValueError(
            f"AS aliases are not allowed in entity-entity queries (the "
            f"node-id prefix is the literal table.column): {query!r}")
    if parts[0].lower() != "select":
        raise ValueError(f"entity-entity query must start with SELECT: {query!r}")
    first = parts[1]
    if not first.endswith(","):
        raise ValueError(
            f"missing ',' after the first column in: {query!r}")
    t1c1 = first[:-1].split(".")
    t2c2 = parts[2].split(".")
    if len(t1c1) != 2 or len(t2c2) != 2:
        raise ValueError(
            f"entity-entity queries select exactly table1.col1, table2.col2 "
            f"(got {parts[1]} {parts[2]}) in: {query!r}")
    if parts[3].lower() != "from":
        raise ValueError(
            f"expected FROM after the two selected columns in: {query!r}")
    return t1c1[0], t1c1[1], t2c2[0], t2c2[1]


def _clean(token) -> str:
    return str(token).strip().strip("\t.'\" ").lower()


def _fetch_budget() -> int:
    """Half the machine's available memory, in rows-ish units (the
    reference's get_init_fetch_size, marius_db2graph.py:243)."""
    try:
        import psutil
        return int(min(psutil.virtual_memory().available / 2, MAX_FETCH_SIZE))
    except Exception:
        return 64 * FETCH_SIZE


def extract_entity_edges(conn, db_type: str, queries: Sequence[str],
                         relations: Sequence[str], out_path: str) -> int:
    """Stream each validated entity-entity query into ``out_path`` as
    src\trel\tdst rows with table_column-prefixed node ids. Returns the
    number of rows written."""
    assert len(queries) == len(relations), \
        "each entity-entity query needs a relation name"
    n = 0
    limit = _fetch_budget()
    with open(out_path, "w") as out:
        for i, (query, rel) in enumerate(zip(queries, relations)):
            t1, c1, t2, c2 = validate_entity_entity_query(query)
            cur = _cursor(conn, db_type, f"edge_entity_entity_cursor{i}")
            cur.execute(query)
            fetch = FETCH_SIZE
            first = True
            while True:
                rows = cur.fetchmany(fetch)
                if not rows:
                    break
                seen = set()
                for a, b in rows:
                    a, b = _clean(a), _clean(b)
                    if a in INVALID_ENTRIES or b in INVALID_ENTRIES:
                        continue
                    if (a, b) in seen:  # per-batch dedup (reference parity:
                        continue        # drop_duplicates over the fetch)
                    seen.add((a, b))
                    out.write(f"{t1}_{c1}_{a}\t{rel}\t{t2}_{c2}_{b}\n")
                    n += 1
                if first:
                    # grow toward the memory budget after a measured batch
                    # (get_fetch_size, marius_db2graph.py:264)
                    fetch = max(FETCH_SIZE, min(limit // 256, 1_000_000))
                    first = False
    return n


def _load_reference_queries(path: str) -> Tuple[List[str], List[str]]:
    """The reference's edges_queries FILE format: alternating lines of
    relation-name, query (config_parser_fn, marius_db2graph.py:104-128).
    Empty lines are an error, as there."""
    rels, queries = [], []
    with open(path) as f:
        for i, line in enumerate(f.read().splitlines()):
            line = line.strip()
            if line == "":
                raise ValueError(
                    "empty lines are not allowed in the edges_queries file")
            (rels if i % 2 == 0 else queries).append(line)
    if len(rels) != len(queries):
        raise ValueError("edges_queries file must alternate relation-name "
                         "and query lines (odd line count found)")
    return queries, rels


def run_db2graph(config_path: str, output_dir: str) -> str:
    """Config YAML — either spelling:

    - ``{db_type, connection: {...}, edge_queries: [SQL, ...]}`` (free-form
      rows written verbatim), optionally plus
      ``entity_edge_queries: [SQL, ...]`` with ``entity_edge_relations``.
    - the reference's ``{db_server, db_name, db_user, db_password, db_host,
      edges_queries: <file>}`` (entity-entity mode).
    """
    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    if "db_server" in cfg:  # reference spelling
        db_type = cfg["db_server"]
        connection = {"user": cfg.get("db_user"),
                      "password": cfg.get("db_password"),
                      "host": cfg.get("db_host"),
                      "database": cfg.get("db_name")}
        queries, rels = _load_reference_queries(cfg["edges_queries"])
        os.makedirs(output_dir, exist_ok=True)
        out_path = os.path.join(output_dir, "edges.txt")
        conn = _connect(db_type, **connection)
        try:
            n = extract_entity_edges(conn, db_type, queries, rels, out_path)
        finally:
            conn.close()
        if n == 0:
            raise RuntimeError("edge queries returned no rows")
        return out_path
    if cfg.get("entity_edge_queries"):
        conn = _connect(cfg["db_type"], **(cfg.get("connection") or {}))
        os.makedirs(output_dir, exist_ok=True)
        out_path = os.path.join(output_dir, "edges.txt")
        try:
            n = extract_entity_edges(
                conn, cfg["db_type"], cfg["entity_edge_queries"],
                cfg["entity_edge_relations"], out_path)
        finally:
            conn.close()
        if n == 0:
            raise RuntimeError("edge queries returned no rows")
        return out_path
    return extract_edges(
        db_type=cfg["db_type"],
        connection=cfg.get("connection") or {},
        edge_queries=cfg["edge_queries"],
        output_dir=output_dir,
    )


def extract_edges(db_type: str, connection: dict, edge_queries: Iterable[str],
                  output_dir: str, filename: str = "edges.txt") -> str:
    """Free-form mode: each query's rows are written verbatim (2 or 3
    columns), streamed in fetchmany batches."""
    conn = _connect(db_type, **connection)
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, filename)
    n = 0
    with open(out_path, "w") as out:
        for i, q in enumerate(edge_queries):
            cur = _cursor(conn, db_type, f"edge_cursor{i}")
            cur.execute(q)
            while True:
                rows = cur.fetchmany(FETCH_SIZE)
                if not rows:
                    break
                for row in rows:
                    if len(row) == 2:
                        out.write(f"{row[0]}\t{row[1]}\n")
                    else:
                        out.write(f"{row[0]}\t{row[1]}\t{row[2]}\n")
                    n += 1
    conn.close()
    if n == 0:
        raise RuntimeError("edge queries returned no rows")
    return out_path
