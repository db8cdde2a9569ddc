"""The share of the window's admissions whose image encoding (the tower
and the Q-Former) replayed a CUDA graph: the batcher's
``encode_graph_replays`` over its ``admits``. None where the program keeps
no such counter."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    s = rec["window"]["stats"]
    if "encode_graph_replays" not in s or not s["admits"]:
        return None
    return s["encode_graph_replays"] / s["admits"]
