"""``gait_update_ms.fleet``: ms of one gait update at the fleet's batch,
the median of the gait update replayed alone as a graph."""
import statistics


def read(record):
    spans = record.get("spans", {}).get("gait_update_ms")
    return statistics.median(spans) if spans else None
