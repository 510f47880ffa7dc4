"""sha256 of kernel outputs on seeded operands, to compare the bits of two
trees of this repository on one card.

    python saev_tpu_torch/scripts/digests.py [ROOT]

Imports `saev_tpu_torch` from ROOT (default: the checkout that holds this
file) and prints one line for each kernel: P2's E, err_full and loss and K2's E,
xhat and loss on `proto_gouter.inputs()`, K7's f32 base and xhat, K3's df
and dA and K4's dW on `kprof.inputs()`.
Run it once with each tree's root in one call; equal lines mean equal bits.
It uses only functions that the commits since P2's port all have.
"""

import hashlib
import pathlib
import sys


def output_digest(*outs) -> str:
    """sha256 of the tensors' bytes, in order."""
    import torch

    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv: list[str]) -> None:
    root = pathlib.Path(argv[0] if argv else pathlib.Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import saev_tpu_torch
    from saev_tpu_torch.ops import cuda_matryoshka as cm
    from saev_tpu_torch.scripts import kprof, proto_gouter

    where = pathlib.Path(saev_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise SystemExit(f"saev_tpu_torch came from {where}, not from {root}")
    print(f"digests of {root}: {kprof.card()}")
    g = proto_gouter.inputs()
    args = tuple(g[k] for k in ("f", "w", "x", "b_dec", "inv_upper", "m", "r"))
    print(f"P2 e, err_full, loss: {output_digest(*proto_gouter.grouped_prefix_err_gouter(*args))}")
    print(f"K2 e, xhat, loss: {output_digest(*cm.grouped_prefix_err(*args))}")
    del g, args
    k = kprof.inputs()
    print(f"K7 base, xhat: {output_digest(*cm.grouped_prefix_base(k['f'], k['w'], k['m'], k['r'], group_size=kprof.G))}")
    df, da = cm.grouped_matmul_dgrad(k["w"], k["e"], k["m"], k["r"], k["scale"], group_size=kprof.G,
                                     df_dtype=torch.bfloat16)
    print(f"K3 df, dA: {output_digest(df, da)}")
    dw = cm.grouped_matmul_wgrad(k["f"], k["da"], k["e"], k["m"], k["r"], k["scale"], group_size=kprof.G)
    print(f"K4 dW: {output_digest(dw)}")


if __name__ == "__main__":
    main(sys.argv[1:])
