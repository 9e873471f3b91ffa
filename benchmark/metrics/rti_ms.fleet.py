"""``rti_ms.fleet``: ms of one real-time iteration at the fleet's batch,
the median of the RTI block replayed alone as a graph, over its RTIs."""
import statistics


def read(record):
    spans = record.get("spans", {}).get("rti_ms")
    return statistics.median(spans) if spans else None
