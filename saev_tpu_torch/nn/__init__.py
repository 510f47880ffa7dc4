"""The SAE and its training objective, and SAE files in the reference's
format: the JAX package's public surface name for name (saev_tpu/nn/__init__.py).
`load` reads an SAE file onto the card unless given `device="cpu"`."""

from . import modeling, objectives, serialize
from .modeling import (
    AuxK,
    BatchTopK,
    EncodeOut,
    L1Sparsity,
    NoAux,
    NoSparsity,
    Output,
    Relu,
    SparseAutoencoderConfig,
    TopK,
    decode,
    encode,
    forward,
    init,
    normalize_w_dec,
    remove_parallel_grads,
)
from .objectives import Matryoshka, MatryoshkaLoss, ObjectiveConfig, matryoshka_loss, sample_prefixes
from .serialize import dump, load

__all__ = [
    "AuxK",
    "BatchTopK",
    "EncodeOut",
    "L1Sparsity",
    "Matryoshka",
    "MatryoshkaLoss",
    "NoAux",
    "NoSparsity",
    "ObjectiveConfig",
    "Output",
    "Relu",
    "SparseAutoencoderConfig",
    "TopK",
    "decode",
    "dump",
    "encode",
    "forward",
    "init",
    "load",
    "matryoshka_loss",
    "modeling",
    "normalize_w_dec",
    "objectives",
    "remove_parallel_grads",
    "sample_prefixes",
    "serialize",
]
