"""The whole step's share of the card's peak: the products' operations that
each SAE's step and log step need (lib/work.py, from the configuration's
shapes: bf16 at 989 TFLOP/s, the log step's f32 at 67), for every step of
the traced run's window, over the window's time."""


def read(run):
    c = run.counts
    if not c.get("window_s"):
        return None
    least = c["steps"] * run.model_s["step_model"] + c["logs"] * run.model_s["log_model"]
    return 100.0 * least / c["window_s"]
