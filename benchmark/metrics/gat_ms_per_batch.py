"""Host self time of the GAT layers (the program's ``gat.layer`` spans)
inside training batches, over the spanned cycles' ``train.batches``. None
where no such span was opened (a program without it, or a cell without GAT
layers)."""
from benchmark.harness import program_trace


def read(ctx):
    p = program_trace.measured(ctx)
    spanned = (p or {}).get("spanned", {})
    spans, batches = spanned.get("spans", []), spanned.get("counters", {}).get("train.batches", 0)
    inside = [i for i, r in enumerate(spans)
              if r[0] == "gat.layer" and program_trace.has_ancestor(spans, i, "train.batch")]
    if not inside or not batches:
        return None
    selfs = program_trace.self_ns(spans)
    return sum(selfs[i] for i in inside) * 1e-6 / batches
