"""``tick_ms.sim``: ms of one control tick of the simulated fleet (the
torque QP on the MPC plan, the IK, four physics substeps), the median of
the tick replayed alone as a graph."""
import statistics


def read(record):
    spans = record.get("spans", {}).get("tick_ms")
    return statistics.median(spans) if spans else None
