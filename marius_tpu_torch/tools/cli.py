"""Console entry points (setup.cfg:60-68 in the reference: marius_train,
marius_eval, marius_preprocess, marius_predict, marius_postprocess,
marius_config_generator, marius_env_info, marius_db2graph).

Port of ``marius_tpu/tools/cli.py``: the same commands, arguments and
printed JSON, installed as ``marius_torch``, ``marius_train_torch`` and so
on, or run as ``python -m marius_tpu_torch.tools.cli <command> ...``. Each
command function takes ``argv`` and a keyword ``device``: None (every
command run from the shell) means the GPU, and the commands that train,
evaluate or size a config raise without one; tests pass ``"cpu"``.

``train`` and ``eval`` join a process group when ``MARIUS_COORDINATOR``
(``host:port``, or a ``tcp://`` / ``file://`` URL), ``MARIUS_NUM_PROCESSES``
and ``MARIUS_PROCESS_ID`` are set, as the JAX commands join
``jax.distributed`` (``marius_tpu/tools/cli.py:12-28``); every process runs
the same command, ``training.mesh`` lays the ranks out, only rank 0 prints
the metrics, and every rank leaves the group at the end:

    MARIUS_COORDINATOR=localhost:29500 MARIUS_NUM_PROCESSES=4 \
    MARIUS_PROCESS_ID=<i> python -m marius_tpu_torch.tools.cli train config.yaml
"""

from __future__ import annotations

import argparse
import json
import sys


def _maybe_init_multihost(device=None):
    """Join the process group when the multi-process variables are set;
    returns (whether it joined, this rank's device or ``device``)."""
    import os
    coord = os.environ.get("MARIUS_COORDINATOR")
    if not coord:
        return False, device
    from marius_tpu_torch.parallel import multihost
    dev = multihost.initialize(coord, num_processes=int(os.environ["MARIUS_NUM_PROCESSES"]),
                               process_id=int(os.environ["MARIUS_PROCESS_ID"]), device=device)
    return True, dev


def _run_in_group(run, args, device):
    """``run(config, model_dir, device)``, inside the process group when the
    variables ask for one; (result, whether this process prints)."""
    joined, device = _maybe_init_multihost(device)
    if not joined:
        return run(args.config, model_dir=args.model_dir, device=device), True
    import torch.distributed as dist
    from marius_tpu_torch.parallel import multihost
    try:
        return run(args.config, model_dir=args.model_dir, device=device), dist.get_rank() == 0
    finally:
        multihost.shutdown()


def marius_train(argv=None, device=None):
    p = argparse.ArgumentParser("marius_train", description="Config-driven training")
    p.add_argument("config", help="path to YAML config")
    p.add_argument("--model_dir", default=None)
    args = p.parse_args(argv)
    from marius_tpu_torch.manager import marius_train as run
    result, prints = _run_in_group(run, args, device)
    if "test" in result and prints:
        print(json.dumps({k: v for k, v in result["test"].items()
                          if isinstance(v, (int, float, str))}))
    return 0


def marius_eval(argv=None, device=None):
    p = argparse.ArgumentParser("marius_eval", description="Evaluate a trained model")
    p.add_argument("config", help="path to YAML config")
    p.add_argument("--model_dir", default=None)
    args = p.parse_args(argv)
    from marius_tpu_torch.manager import marius_eval as run
    result, prints = _run_in_group(run, args, device)
    for split in ("test", "valid"):
        if split in result and prints:
            print(json.dumps({k: v for k, v in result[split].items()
                              if isinstance(v, (int, float, str))}))
    return 0


def marius_preprocess(argv=None, device=None):
    p = argparse.ArgumentParser("marius_preprocess",
                                description="Download + preprocess a dataset")
    p.add_argument("--dataset", default=None,
                   help="built-in dataset name (see --list)")
    p.add_argument("--list", action="store_true", help="list built-in datasets")
    p.add_argument("--output_directory", default="datasets/")
    p.add_argument("--edges", nargs="+", default=None,
                   help="custom raw edge files: train [valid test]")
    p.add_argument("--dataset_split", nargs="+", type=float, default=None)
    p.add_argument("--num_partitions", type=int, default=1)
    p.add_argument("--partitioned_eval", action="store_true")
    p.add_argument("--no_remap_ids", action="store_true")
    p.add_argument("--sequential_train_nodes", action="store_true")
    p.add_argument("--sequential_deg_nodes", type=int, default=0,
                   help="assign the top-k highest-degree nodes sequential ids "
                        "(partition-buffer locality)")
    p.add_argument("--delim", default="\t")
    p.add_argument("--columns", nargs="+", type=int, default=[0, 1, 2],
                   help="src [rel] dst column indices")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--chunked", action="store_true",
                   help="out-of-core conversion for edge files larger than "
                        "RAM (streaming two-pass; the reference covers this "
                        "regime with its Spark converter)")
    p.add_argument("--chunk_rows", type=int, default=None,
                   help="resident edge rows per chunk in --chunked mode")
    args = p.parse_args(argv)

    from marius_tpu_torch.tools.preprocess.datasets import DATASET_REGISTRY
    if args.list:
        print("\n".join(sorted(DATASET_REGISTRY)))
        return 0

    if args.dataset:
        cls = DATASET_REGISTRY.get(args.dataset.lower())
        if cls is None:
            print(f"Unknown dataset {args.dataset}; --list shows options",
                  file=sys.stderr)
            return 1
        ds = cls(args.output_directory)
        ds.download(overwrite=args.overwrite)
        ds.preprocess(num_partitions=args.num_partitions,
                      remap_ids=not args.no_remap_ids,
                      splits=args.dataset_split,
                      sequential_train_nodes=args.sequential_train_nodes,
                      partitioned_eval=args.partitioned_eval)
    elif args.edges:
        cols = args.columns
        has_rel = len(cols) == 3
        kwargs = dict(
            output_dir=args.output_directory,
            train_edges=args.edges[0],
            valid_edges=args.edges[1] if len(args.edges) > 1 else None,
            test_edges=args.edges[2] if len(args.edges) > 2 else None,
            splits=args.dataset_split,
            delim=args.delim,
            src_column=cols[0],
            edge_type_column=cols[1] if has_rel else None,
            dst_column=cols[-1],
            remap_ids=not args.no_remap_ids,
            num_partitions=args.num_partitions,
            partitioned_evaluation=args.partitioned_eval,
        )
        if args.chunked:
            from marius_tpu_torch.tools.preprocess.chunked_converter import (
                ChunkedEdgeListConverter,
            )
            if args.chunk_rows:
                kwargs["chunk_rows"] = args.chunk_rows
            ChunkedEdgeListConverter(**kwargs).convert()
        else:
            from marius_tpu_torch.tools.preprocess.converter import EdgeListConverter
            kwargs["sequential_deg_nodes"] = args.sequential_deg_nodes
            EdgeListConverter(**kwargs).convert()
    else:
        p.error("either --dataset or --edges is required")
    return 0


def marius_predict(argv=None, device=None):
    p = argparse.ArgumentParser("marius_predict", description="Batch inference")
    p.add_argument("--config", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--metrics", nargs="*", default=None)
    p.add_argument("--save_scores", action="store_true")
    p.add_argument("--save_ranks", action="store_true")
    p.add_argument("--save_labels", action="store_true")
    p.add_argument("--input_file", default=None)
    p.add_argument("--split", default="test", choices=["valid", "test"])
    args = p.parse_args(argv)
    from marius_tpu_torch.tools.predict import run_predict
    results = run_predict(args.config, args.output_dir, split=args.split,
                          metrics=args.metrics, save_scores=args.save_scores,
                          save_ranks=args.save_ranks, save_labels=args.save_labels,
                          input_file=args.input_file, device=device)
    print(json.dumps({k: v for k, v in results.items()
                      if isinstance(v, (int, float, str))}))
    return 0


def marius_postprocess(argv=None, device=None):
    p = argparse.ArgumentParser("marius_postprocess", description="Export embeddings")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--format", default="csv", choices=["csv", "parquet", "bin"])
    p.add_argument("--dataset_dir", default=None,
                   help="dataset dir holding node_mapping.txt for inverse remap")
    args = p.parse_args(argv)
    from marius_tpu_torch.tools.postprocess import export_node_embeddings
    out = export_node_embeddings(args.model_dir, args.output_dir,
                                 fmt=args.format, dataset_dir=args.dataset_dir)
    print(out)
    return 0


def marius_config_generator(argv=None, device=None):
    p = argparse.ArgumentParser("marius_config_generator",
                                description="Generate a training config")
    p.add_argument("dataset_dir")
    p.add_argument("--output", default=None)
    p.add_argument("--task", default="LINK_PREDICTION",
                   choices=["LINK_PREDICTION", "NODE_CLASSIFICATION", "lp", "nc"])
    p.add_argument("--model", default="DISTMULT")
    p.add_argument("--embedding_dim", type=int, default=50)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=0.1)
    p.add_argument("--num_partitions", type=int, default=None,
                   help="default: sized automatically from dataset stats + "
                        "the GPU's memory (partition buffer only when needed)")
    args = p.parse_args(argv)
    task = {"lp": "LINK_PREDICTION", "nc": "NODE_CLASSIFICATION"}.get(
        args.task, args.task)
    from marius_tpu_torch.tools.config_generator import generate_config
    import yaml
    raw = generate_config(args.dataset_dir, output_path=args.output, task=task,
                          model=args.model, embedding_dim=args.embedding_dim,
                          num_epochs=args.num_epochs, batch_size=args.batch_size,
                          learning_rate=args.learning_rate,
                          num_partitions=args.num_partitions, device=device)
    if not args.output:
        print(yaml.safe_dump(raw, sort_keys=False))
    return 0


def marius_env_info(argv=None, device=None):
    argparse.ArgumentParser("marius_env_info").parse_args(argv)
    from marius_tpu_torch.tools.env_info import format_env_info
    print(format_env_info())
    return 0


def marius_db2graph(argv=None, device=None):
    p = argparse.ArgumentParser("marius_db2graph",
                                description="SQL database -> edge list")
    p.add_argument("--config_path", required=True)
    p.add_argument("--output_directory", required=True)
    args = p.parse_args(argv)
    from marius_tpu_torch.tools.db2graph import run_db2graph
    print(run_db2graph(args.config_path, args.output_directory))
    return 0


def marius_verify_baselines(argv=None, device=None):
    from marius_tpu_torch.tools.verify_baselines import main as run
    return run(argv, device=device)


def main(argv=None, device=None):
    """`marius <subcommand>` umbrella (marius.cpp:187 main dispatch)."""
    commands = {
        "train": marius_train, "eval": marius_eval,
        "preprocess": marius_preprocess, "predict": marius_predict,
        "postprocess": marius_postprocess,
        "config_generator": marius_config_generator,
        "env_info": marius_env_info, "db2graph": marius_db2graph,
        "verify_baselines": marius_verify_baselines,
    }
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in commands:
        print(f"usage: marius {{{','.join(commands)}}} ...", file=sys.stderr)
        return 1
    return commands[argv[0]](argv[1:], device=device)


if __name__ == "__main__":
    sys.exit(main())
