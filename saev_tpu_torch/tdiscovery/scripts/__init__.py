"""Trait discovery's data preparation (counterpart of contrib/trait_discovery/
scripts): `format_ade20k` and `format_fishvista` put a download into the
ImgSegFolder or ImgFolder layout, `download_butterflies` writes the
Cambridge butterflies (`materialize`; `fetch` needs the network),
`scrape_fishbase` reads FishBase's summary pages into a trait CSV
(`parse_environment`, `load_species`; `scrape` needs the network), and
`push_dinov3` selects, preflight-loads (on the card unless `--device cpu`),
stages and publishes SAE checkpoints (`--dry-run` stops before the
network's `upload`). Each runs with `python -m`.
"""
