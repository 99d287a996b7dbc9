"""GiB of GAT slot blocks a training batch's forward gathers: the program's
``gat.slot_bytes`` counter over the spanned cycles' ``train.batches``. None
where the program counts no such bytes (a program without the counter, or a
cell without GAT layers)."""
from benchmark.harness import program_trace


def read(ctx):
    p = program_trace.measured(ctx)
    counts = (p or {}).get("spanned", {}).get("counters", {})
    batches = counts.get("train.batches", 0)
    if "gat.slot_bytes" not in counts or not batches:
        return None
    return counts["gat.slot_bytes"] / batches / float(1 << 30)
