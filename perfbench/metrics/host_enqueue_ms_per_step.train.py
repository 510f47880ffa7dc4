"""Host ms a step spent enqueueing the sweep's step calls and `record_stats`
(`StepRouter`, `make_train_step`), from the benchmark's host clock around
each call in the traced run's window, summed over the cohorts."""


def read(run):
    value = run.host_s.get("enqueue_per_step")
    return None if value is None else 1e3 * value
