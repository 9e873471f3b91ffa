"""``device_idle.fleet``: the share of one traced cycle's wall time in
which no operation ran on the device."""


def read(record):
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
