"""The birdsong study's model internals on PyTorch tensors (counterpart of
contrib/birdsong/src/birdsong's `trace`): the channel trace of Bird-MAE's
residual stream, on the card where the model's params are."""
