"""Device ms of one log step's `make_metrics_fn` calls (every cohort's), from
CUDA events around the calls in the traced run's window."""


def read(run):
    return run.event_ms.get("metrics_call")
