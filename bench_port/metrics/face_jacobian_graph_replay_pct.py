"""face_jacobian_graph_replay_pct: the share of the window's SEB
face-Jacobian calls that replayed a CUDA graph, 100 x
``face_jacobian_replays`` ÷ (their sum with ``face_jacobian_eager`` and
``face_jacobian_captures``), the counters of the driver's timing rows.
None where no row carries them."""

KEYS = ("face_jacobian_eager", "face_jacobian_captures",
        "face_jacobian_replays")


def read(record):
    rows = record.get("timing_rows")
    if not rows:
        return None
    calls = {k: sum(r.get(k, 0) for r in rows) for k in KEYS}
    total = sum(calls.values())
    if not total:
        return None
    return 100.0 * calls["face_jacobian_replays"] / total
