"""jacobian_graph_replay_pct: the share of the window's element-Jacobian
calls that replayed a CUDA graph, 100 x ``jacobian_replays`` ÷ (their sum
with ``jacobian_eager`` and ``jacobian_captures``), the counters of the
driver's timing rows.  None where no row carries them."""

KEYS = ("jacobian_eager", "jacobian_captures", "jacobian_replays")


def read(record):
    rows = record.get("timing_rows")
    if not rows:
        return None
    calls = {k: sum(r.get(k, 0) for r in rows) for k in KEYS}
    total = sum(calls.values())
    if not total:
        return None
    return 100.0 * calls["jacobian_replays"] / total
