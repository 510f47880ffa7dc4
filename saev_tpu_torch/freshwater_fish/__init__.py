"""The freshwater-fish study's tools (counterpart of contrib/freshwater_fish/
scripts): `extract_tol` pulls fish images out of a TreeOfLife-200M-style
store (pyarrow, h5py, Pillow) into the ImgFolder layout that extraction
reads, and `make_gallery` packs `tdiscovery.visuals`' per-latent images and
`var.parquet` into one species-captioned HTML gallery (pandas, Pillow).
Host-only; each optional package is imported where used and a missing one
raises an ImportError that names it.

    python -m saev_tpu_torch.freshwater_fish.extract_tol extract --order-filter Cypriniformes ...
    python -m saev_tpu_torch.freshwater_fish.make_gallery gallery --run runs/<id> --shards <dir> ...
"""
