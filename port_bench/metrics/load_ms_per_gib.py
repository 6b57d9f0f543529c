"""load_ms_per_gib: the host's data path of the streaming build, in ms a
GiB committed.

The program's own span: StreamingStats.datagen_s of models/streaming.py,
summed over the traced window's slots.  For file-backed data it covers the
read of each chunk's cells (models/data.load_cells) and the pageable copy
to the card, both synchronous; for fake data it times only the dispatch of
K3, so only file-backed cells list this metric.
"""


def read(rec: dict):
    stats = rec.get("stats")
    if not stats or rec["gib"] <= 0:
        return None
    return 1e3 * stats["datagen_s"] / rec["gib"]
