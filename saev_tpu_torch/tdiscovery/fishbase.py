"""FishBase ecology-trait x body-part latent discovery (counterpart of
contrib/trait_discovery/src/tdiscovery/fishbase.py).

Capability port of the reference's 004_fishbase notebook
(`contrib/trait_discovery/notebooks/004_fishbase.py:608-935`, a 1,398-line
marimo app). The protocol: join FishVista species labels to FishBase
ecological traits (habitat, migration, ...), build binary patch-level targets
"this patch is body-part P on a fish with trait value T", score EVERY SAE
latent against each target with a cheap vectorized statistic, and report the
best latent per (part x trait) cell as a table — the raw material for claims
like "latent 713 fires on the caudal fin of pelagic cruisers".

The reference pulls the trait table from a FishBase snapshot inside the
notebook; here the table is an explicit input (CSV or mapping), so the whole
module runs hermetically on fake shards.
"""

import dataclasses
import logging
import pathlib

import numpy as np

logger = logging.getLogger("td.fishbase")

# FishVista body-part segmentation classes, index = labels.bin value
# (reference 004_fishbase.py:797-808).
PART_NAMES = (
    "Background",
    "Head",
    "Eye",
    "Dorsal fin",
    "Pectoral fin",
    "Pelvic fin",
    "Anal fin",
    "Caudal fin",
    "Adipose fin",
    "Barbel",
)

# FishBase habitat vocabulary in the reference's category order
# (004_fishbase.py:909-921).
HABITATS = (
    "reef-associated",
    "pelagic-oceanic",
    "pelagic-neritic",
    "bathypelagic",
    "bathydemersal",
    "benthopelagic",
    "pelagic",
    "epipelagic",
    "mesopelagic",
    "abyssopelagic",
    "demersal",
)

# Ecologically-motivated habitat groupings (reference 004_fishbase.py:775-788):
# each comparison contrasts two swimming/lifestyle regimes.
HABITAT_COMPARISONS = (
    {
        "cruisers": ("pelagic-oceanic", "pelagic-neritic", "pelagic"),
        "maneuverers": ("reef-associated",),
    },
    {
        "pelagic": ("pelagic-oceanic", "pelagic-neritic", "pelagic", "epipelagic"),
        "demersal": ("demersal", "bathydemersal", "benthopelagic"),
    },
    {
        "shallow": ("epipelagic", "reef-associated", "pelagic-neritic"),
        "deep": ("mesopelagic", "bathypelagic", "abyssopelagic", "bathydemersal"),
    },
)


# ---------------------------------------------------------------------------
# Per-latent scoring primitives (reference 004_fishbase.py:686-758)
# ---------------------------------------------------------------------------


def fast_auc(acts: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-column ROC-AUC of `acts (n, d)` against binary `labels (n,)` via
    the rank statistic: AUC = (mean positive rank - (n_pos+1)/2) / n_neg.
    Ties get average ranks, so constant columns score exactly 0.5."""
    import scipy.stats

    labels = np.asarray(labels, dtype=bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    assert 0 < n_pos < labels.size, "labels must contain both classes"
    ranks = scipy.stats.rankdata(acts, axis=0)
    mean_rank_pos = ranks[labels].mean(axis=0)
    return (mean_rank_pos - (n_pos + 1) / 2) / n_neg


def fast_pearson(acts: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-column Pearson correlation with a binary target (point-biserial)."""
    y = np.asarray(labels, dtype=np.float64)
    xc = acts - acts.mean(axis=0)
    yc = y - y.mean()
    cov = xc.T @ yc
    x_std = np.sqrt((xc**2).sum(axis=0))
    y_std = np.sqrt((yc**2).sum())
    return cov / (x_std * y_std + 1e-10)


def activation_freq_ratio(
    acts: np.ndarray, labels: np.ndarray, threshold: float = 0.1
) -> np.ndarray:
    """Per-column log odds ratio log(P(act>t | y=1) / P(act>t | y=0))."""
    labels = np.asarray(labels, dtype=bool)
    active = acts > threshold
    eps = 1e-8
    freq_pos = active[labels].mean(axis=0)
    freq_neg = active[~labels].mean(axis=0)
    return np.log((freq_pos + eps) / (freq_neg + eps))


# Two-phase forms: prepare() does the target-independent work ONCE (ranking
# / centering / thresholding the full (n_patches, d_sae) matrix), score_from()
# is cheap per target — the (part x trait) sweeps call score_fn ~100+ times.


def _prepare_pearson(acts: np.ndarray) -> dict:
    xc = acts - acts.mean(axis=0)
    return {"xc": xc, "x_std": np.sqrt((xc**2).sum(axis=0))}


def _pearson_from(state: dict, labels: np.ndarray) -> np.ndarray:
    y = np.asarray(labels, dtype=np.float64)
    yc = y - y.mean()
    cov = state["xc"].T @ yc
    y_std = np.sqrt((yc**2).sum())
    return cov / (state["x_std"] * y_std + 1e-10)


def _prepare_auc(acts: np.ndarray) -> dict:
    import scipy.stats

    return {"ranks": scipy.stats.rankdata(acts, axis=0)}


def _auc_from(state: dict, labels: np.ndarray) -> np.ndarray:
    labels = np.asarray(labels, dtype=bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    assert 0 < n_pos < labels.size, "labels must contain both classes"
    mean_rank_pos = state["ranks"][labels].mean(axis=0)
    return (mean_rank_pos - (n_pos + 1) / 2) / n_neg


def _prepare_log_odds(acts: np.ndarray, threshold: float = 0.1) -> dict:
    return {"active": acts > threshold}


def _log_odds_from(state: dict, labels: np.ndarray) -> np.ndarray:
    labels = np.asarray(labels, dtype=bool)
    eps = 1e-8
    freq_pos = state["active"][labels].mean(axis=0)
    freq_neg = state["active"][~labels].mean(axis=0)
    return np.log((freq_pos + eps) / (freq_neg + eps))


PREPARED_SCORERS = {
    "pearson": (_prepare_pearson, _pearson_from),
    "auc": (_prepare_auc, _auc_from),
    "log_odds": (_prepare_log_odds, _log_odds_from),
}

SCORERS = {
    "pearson": fast_pearson,
    "auc": fast_auc,
    "log_odds": activation_freq_ratio,
}


# ---------------------------------------------------------------------------
# Species → trait join (reference load_fishvista_df + fishbase_df join,
# 004_fishbase.py:608-681)
# ---------------------------------------------------------------------------


def parse_species(label: str) -> dict[str, str]:
    """Split a FishVista species label 'Family_Genus[_species]' into parts."""
    names = label.strip().split("_")
    out = {"label": label.strip(), "family": "", "genus": "", "species": ""}
    if len(names) == 2:
        out["family"], out["genus"] = names
    elif len(names) == 3:
        out["family"], out["genus"], out["species"] = names
    return out


def load_trait_table(fpath: pathlib.Path) -> dict[tuple[str, str], dict[str, str]]:
    """CSV with columns genus,species,<trait...> → {(genus, species): traits}.
    Keys are lowercased — the scraper writes lowercase and FishVista labels
    carry capitalized genus, so case must not decide a join."""
    import csv

    table: dict[tuple[str, str], dict[str, str]] = {}
    with open(fpath, newline="") as fd:
        for row in csv.DictReader(fd):
            genus = row.pop("genus").strip().lower()
            species = row.pop("species").strip().lower()
            # Values lowercased too: the HABITATS vocab is lowercase, and a CSV
            # with "Demersal" must not silently map every row to unknown.
            table[(genus, species)] = {
                k: v.strip().lower() for k, v in row.items()
            }
    return table


def example_traits(
    species_labels: list[str],
    trait_table: dict[tuple[str, str], dict[str, str]],
    trait: str,
    vocab: tuple[str, ...] = HABITATS,
) -> np.ndarray:
    """Per-example trait index into `vocab` (-1 = unknown species or value),
    the left-join of 004_fishbase.py:660-675 without polars categoricals."""
    index = {v: i for i, v in enumerate(vocab)}
    # Case-insensitive join: parse_species keeps FishVista's capitalized
    # genus, the trait table is lowercased (load_trait_table).
    table = {
        (g.lower(), s.lower()): traits for (g, s), traits in trait_table.items()
    }
    out = np.full(len(species_labels), -1, dtype=np.int32)
    for i, label in enumerate(species_labels):
        parts = parse_species(label)
        traits = table.get((parts["genus"].lower(), parts["species"].lower()))
        if traits is not None:
            out[i] = index.get(traits.get(trait, "").lower(), -1)
    return out


# ---------------------------------------------------------------------------
# (part × trait) scoring + tables (reference 004_fishbase.py:763-935)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PartTraitScores:
    """scores[latent, part, target] for one trait scoring sweep."""

    scores: np.ndarray
    parts: tuple[str, ...]
    targets: tuple[str, ...]

    def best_latents(self) -> set[int]:
        """Union of the best |score| latent for every SCORED (part, target)
        cell — the latents worth rendering visuals for (004_fishbase.py:
        884-890). Cells skipped by score_part_by_trait (no positive or no
        negative patches) stay all-zero and must not nominate latent 0."""
        out = set()
        flat = np.abs(self.scores).reshape(self.scores.shape[0], -1)
        for j in range(flat.shape[1]):
            if flat[:, j].max() > 0:
                out.add(int(flat[:, j].argmax()))
        return out

    def table(self) -> list[dict[str, object]]:
        """One row per SCORED (part, target): the best latent and its |score|
        (004_fishbase.py:893-935). Skipped cells (all-zero score column) are
        omitted — argmax of zeros would fabricate latent 0."""
        rows = []
        for p, part in enumerate(self.parts):
            for t, target in enumerate(self.targets):
                col = self.scores[:, p, t]
                if np.abs(col).max() == 0:
                    continue
                best = int(np.abs(col).argmax())
                rows.append({
                    "part": part,
                    "target": target,
                    "latent": best,
                    "score": float(abs(col[best])),
                })
        return rows


def _patch_targets(
    part_labels: np.ndarray, trait_idx_patches: np.ndarray, part: int,
    trait_vals: np.ndarray,
) -> np.ndarray:
    return (part_labels == part) & np.isin(trait_idx_patches, trait_vals)


def score_part_by_trait(
    token_acts: np.ndarray,
    part_labels: np.ndarray,
    trait_idx: np.ndarray,
    tokens_per_example: int,
    *,
    vocab: tuple[str, ...] = HABITATS,
    parts: tuple[str, ...] = PART_NAMES,
    scorer: str = "pearson",
) -> PartTraitScores:
    """Score every latent against 'part P on a fish with trait value V' for
    all (P, V); patches from unknown-trait examples are excluded, matching
    the reference's has_habitat mask (004_fishbase.py:858-878)."""
    prepare, score_from = PREPARED_SCORERS[scorer]
    trait_patches = np.repeat(trait_idx, tokens_per_example)
    assert trait_patches.shape[0] == token_acts.shape[0] == part_labels.shape[0]
    known = trait_patches >= 0
    acts = np.asarray(token_acts[known], dtype=np.float64)
    part_k, trait_k = part_labels[known], trait_patches[known]

    d_sae = acts.shape[1]
    state = prepare(acts)  # target-independent work, once for all cells
    scores = np.zeros((d_sae, len(parts), len(vocab)))
    for p in range(len(parts)):
        for v in range(len(vocab)):
            target = _patch_targets(part_k, trait_k, p, np.array([v]))
            if target.sum() in (0, target.size):
                continue
            scores[:, p, v] = np.nan_to_num(score_from(state, target))
    return PartTraitScores(scores, tuple(parts), tuple(vocab))


def score_part_by_comparison(
    token_acts: np.ndarray,
    part_labels: np.ndarray,
    trait_idx: np.ndarray,
    tokens_per_example: int,
    *,
    comparisons=HABITAT_COMPARISONS,
    vocab: tuple[str, ...] = HABITATS,
    parts: tuple[str, ...] = PART_NAMES,
    scorer: str = "pearson",
) -> PartTraitScores:
    """Same sweep over the named habitat GROUPS (cruisers vs maneuverers,
    ...; reference 004_fishbase.py:775-846). Targets are 'part P on a fish
    in any habitat of group G'."""
    prepare, score_from = PREPARED_SCORERS[scorer]
    index = {v: i for i, v in enumerate(vocab)}
    trait_patches = np.repeat(trait_idx, tokens_per_example)
    assert trait_patches.shape[0] == token_acts.shape[0] == part_labels.shape[0]
    known = trait_patches >= 0
    acts = np.asarray(token_acts[known], dtype=np.float64)
    part_k, trait_k = part_labels[known], trait_patches[known]

    names, val_sets = [], []
    for comp in comparisons:
        for name in sorted(comp):
            names.append(name)
            val_sets.append(np.array([index[v] for v in comp[name]]))

    d_sae = acts.shape[1]
    state = prepare(acts)
    scores = np.zeros((d_sae, len(parts), len(names)))
    for p in range(len(parts)):
        for g, vals in enumerate(val_sets):
            target = _patch_targets(part_k, trait_k, p, vals)
            if target.sum() in (0, target.size):
                continue
            scores[:, p, g] = np.nan_to_num(score_from(state, target))
    return PartTraitScores(scores, tuple(parts), tuple(names))


def trait_coverage(trait_idx: np.ndarray, vocab: tuple[str, ...] = HABITATS):
    """(value, n_examples) histogram of known trait values — the sanity bar
    chart at 004_fishbase.py:938-969."""
    known = trait_idx[trait_idx >= 0]
    counts = np.bincount(known, minlength=len(vocab))
    return [
        {"value": v, "n_examples": int(c)} for v, c in zip(vocab, counts)
    ]
