"""The whole batch's share of the card's peak: the encoder's and the
decode's operations that each batch needs (lib/work.py: the decode's
latents by their nonzeros, f32 at 67 TFLOP/s), for every batch of the traced
run's window, over the window's time."""


def read(run):
    c = run.counts
    if not c.get("window_s"):
        return None
    return 100.0 * c["batches"] * run.model_s["batch_model"] / c["window_s"]
