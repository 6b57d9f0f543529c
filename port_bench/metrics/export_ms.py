"""export_ms: the JSON export of a proof input
(utils/json_export.export_proof_input), in ms a request: the benchmark's
own host clock around each call, averaged over the traced window."""


def read(rec: dict):
    times = rec.get("export_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
