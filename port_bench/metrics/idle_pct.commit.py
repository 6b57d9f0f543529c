"""idle_pct.commit: the share of the traced window in which no kernel,
copy or set ran on the card, in %, in the cells that commit slots of
device data (trace.read)."""


def read(rec: dict):
    if rec["window_s"] <= 0 or rec["device_events"] == 0:
        return None
    return 100 * (1 - rec["busy_s"] / rec["window_s"])
