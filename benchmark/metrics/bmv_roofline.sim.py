"""``bmv_roofline.sim``: the share of their roofline that an RTI period's
``bmv`` calls reach, sum(count x bound) over sum(count x time), each kind
of call replayed alone as a graph (``harness/calls.py``)."""


def read(record):
    r = record.get("roofline", {}).get("bmv")
    if not r or r["ms"] <= 0:
        return None
    return 100.0 * r["bound_ms"] / r["ms"]
