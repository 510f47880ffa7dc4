"""Device ms a batch of `compact_rows` and the distributions' slice, from
CUDA events around them in the traced run's window."""


def read(run):
    return run.event_ms.get("compaction")
