"""Scrape FishBase species-trait pages for the FishVista species list
(counterpart of contrib/trait_discovery/scripts/scrape_fishbase.py).

Capability mirror of reference contrib/trait_discovery/scripts/
scrape_fishbase.py: collect the unique (family, genus, epithet) triples from
every FishVista CSV, fetch each species' FishBase summary page across a pool
of rate-limited mirrors, regex-parse the Environment section into binary
habitat/water/migration traits plus depth/pH/dH ranges, and append rows to a
resumable output CSV (plus an error CSV for failed fetches). The output is
the `--fishbase-csv` input of format_fishvista.py and the trait table of
`tdiscovery.fishbase`.

The reference uses requests + BeautifulSoup + polars; this uses stdlib
urllib/html/csv so the parser and species loader are hermetically testable.

Usage:
    python -m saev_tpu_torch.tdiscovery.scripts.scrape_fishbase scrape \\
        --fishvista data/fish-vista --out data/fishvista_fishbase.csv
"""

import csv
import dataclasses
import html.parser
import logging
import pathlib
import re
import threading
import time
import urllib.error
import urllib.request

logger = logging.getLogger("scrape_fishbase")

MIRRORS = ("org", "se", "de", "net.br", "org.au", "us", "ca")

BINARY_TRAITS = (
    # Habitat/position
    "demersal", "benthopelagic", "bathydemersal", "pelagic",
    "pelagic-neritic", "pelagic-oceanic", "reef-associated",
    # Depth zones
    "epipelagic", "mesopelagic", "bathypelagic", "abyssopelagic",
    # Water type
    "marine", "freshwater", "brackish",
    # Migration
    "anadromous", "catadromous", "amphidromous", "potamodromous",
    "limnodromous", "oceanodromous", "non-migratory",
)

NUMERIC_TRAITS = (
    "min_depth_m", "max_depth_m", "usual_min_depth_m", "usual_max_depth_m",
    "min_ph", "max_ph", "min_dh", "max_dh",
)

ALL_TRAITS = BINARY_TRAITS + NUMERIC_TRAITS

USER_AGENT = (
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 "
    "(KHTML, like Gecko) Chrome/120.0.0.0 Safari/537.36"
)


@dataclasses.dataclass(frozen=True)
class Config:
    fishvista: pathlib.Path = pathlib.Path("./data/fish-vista")
    """FishVista root with the per-split CSV manifests."""
    out: pathlib.Path = pathlib.Path("./data/fishvista_fishbase.csv")
    err_out: pathlib.Path = pathlib.Path("./data/fishvista_fishbase_errors.csv")
    crawl_delay: int = 10
    """Seconds between requests per mirror (FishBase robots.txt)."""
    timeout: int = 30
    max_retries: int = 3


class _TextExtractor(html.parser.HTMLParser):
    """Tag-stripping text extraction (the BeautifulSoup get_text stand-in)."""

    def __init__(self):
        super().__init__()
        self.chunks: list[str] = []
        self._skip = 0

    def handle_starttag(self, tag, attrs):
        if tag in ("script", "style"):
            self._skip += 1

    def handle_endtag(self, tag):
        if tag in ("script", "style") and self._skip:
            self._skip -= 1

    def handle_data(self, data):
        if not self._skip and data.strip():
            self.chunks.append(data.strip())


def page_text(html_src: str) -> str:
    extractor = _TextExtractor()
    extractor.feed(html_src)
    return " ".join(extractor.chunks)


def load_species(fishvista: pathlib.Path) -> list[tuple[str, str, str]]:
    """Unique (family, genus, epithet) across every FishVista CSV with the
    family/standardized_species columns; first family seen wins."""
    seen: set[tuple[str, str]] = set()
    species = []
    for fpath in sorted(fishvista.glob("*.csv")):
        try:
            with open(fpath, newline="") as fd:
                reader = csv.DictReader(fd)
                cols = set(reader.fieldnames or [])
                if not {"family", "standardized_species"} <= cols:
                    continue
                for row in reader:
                    raw = (row["standardized_species"] or "").strip()
                    parts = raw.split()
                    if len(parts) < 2:
                        if raw:
                            logger.warning("Invalid species format: %s", raw)
                        continue
                    genus, epithet = parts[0], parts[1]
                    if (genus, epithet) in seen:
                        continue
                    seen.add((genus, epithet))
                    species.append((row["family"], genus, epithet))
        except OSError as err:
            logger.warning("Failed to read %s: %s", fpath, err)
    return species


def load_existing(out_fpath: pathlib.Path) -> set[tuple[str, str]]:
    """Already-scraped (genus, epithet) pairs — the resume set."""
    if not out_fpath.exists():
        return set()
    try:
        with open(out_fpath, newline="") as fd:
            return {(r["genus"], r["species"]) for r in csv.DictReader(fd)}
    except (OSError, KeyError):
        return set()


def parse_environment(html_src: str) -> dict[str, object] | None:
    """FishBase summary page -> trait dict; None for invalid pages
    (reference parse_environment :152-207 — same regexes on the same text)."""
    text = page_text(html_src)
    if "not in the public version of FishBase" in text:
        return None

    result: dict[str, object] = {trait: "" for trait in ALL_TRAITS}
    text_lower = text.lower()
    for trait in BINARY_TRAITS:
        pattern = trait.replace("-", r"[\s-]")
        if re.search(rf"\b{pattern}\b", text_lower):
            result[trait] = 1.0

    depth = re.search(r"depth range\s*[:\s]*(\?|\d+)\s*-\s*(\?|\d+)\s*m", text_lower)
    if depth:
        lo, hi = depth.groups()
        result["min_depth_m"] = float(lo) if lo != "?" else "?"
        result["max_depth_m"] = float(hi) if hi != "?" else "?"

    usual = re.search(r"usually\s*(\?|\d+)\s*-\s*(\?|\d+)\s*m", text_lower)
    if usual:
        lo, hi = usual.groups()
        result["usual_min_depth_m"] = float(lo) if lo != "?" else "?"
        result["usual_max_depth_m"] = float(hi) if hi != "?" else "?"

    ph = re.search(r"ph\s*(?:range)?[:\s]*(\d+\.?\d*)\s*-\s*(\d+\.?\d*)", text_lower)
    if ph:
        result["min_ph"], result["max_ph"] = float(ph.group(1)), float(ph.group(2))

    dh = re.search(r"dh\s*(?:range)?[:\s]*(\d+\.?\d*)\s*-\s*(\d+\.?\d*)", text_lower)
    if dh:
        result["min_dh"], result["max_dh"] = float(dh.group(1)), float(dh.group(2))

    return result


class MirrorWorker:
    """One FishBase mirror with per-mirror rate limiting and retries."""

    def __init__(self, tld: str, crawl_delay: int, timeout: int, max_retries: int):
        self.tld = tld
        self.crawl_delay = crawl_delay
        self.timeout = timeout
        self.max_retries = max_retries
        self._lock = threading.Lock()
        self._last_request = 0.0

    def _rate_limit(self):
        with self._lock:
            wait = self._last_request + self.crawl_delay - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self._last_request = time.monotonic()

    def url_for(self, genus: str, epithet: str) -> str:
        return (
            f"https://www.fishbase.{self.tld}/summary/"
            f"{genus.capitalize()}_{epithet.lower()}.html"
        )

    def fetch(self, genus: str, epithet: str):
        """(html | None, error_reason | None, url)."""
        url = self.url_for(genus, epithet)
        last_error = "unknown"
        for attempt in range(self.max_retries):
            self._rate_limit()
            req = urllib.request.Request(url, headers={"User-Agent": USER_AGENT})
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return resp.read().decode("utf-8", "replace"), None, url
            except urllib.error.HTTPError as err:
                if err.code in (404, 410):
                    return None, f"http_{err.code}", url
                last_error = f"http_{err.code}"
            except (urllib.error.URLError, TimeoutError, OSError) as err:
                last_error = f"net_{type(err).__name__}"
            time.sleep(2**attempt)
        return None, last_error, url


def scrape(cfg: Config) -> int:
    """Fetch + parse every unscraped species, appending rows as they land."""
    species = load_species(cfg.fishvista)
    done = load_existing(cfg.out)
    # The output CSV stores lowercase genus/species; species from FishVista
    # carry capitalized genus — compare case-insensitively or resume
    # re-scrapes everything.
    todo = [
        (f, g, e) for f, g, e in species
        if (g.lower(), e.lower()) not in done
    ]
    logger.info("%d species total, %d already scraped, %d to go.",
                len(species), len(done), len(todo))

    header = ["family", "genus", "species"] + list(ALL_TRAITS)
    new_out = not cfg.out.exists()
    cfg.out.parent.mkdir(parents=True, exist_ok=True)
    workers = [
        MirrorWorker(tld, cfg.crawl_delay, cfg.timeout, cfg.max_retries)
        for tld in MIRRORS
    ]
    write_lock = threading.Lock()
    with open(cfg.out, "a", newline="") as out_fd, \
            open(cfg.err_out, "a", newline="") as err_fd:
        out_writer = csv.DictWriter(out_fd, fieldnames=header)
        err_writer = csv.writer(err_fd)
        if new_out:
            out_writer.writeheader()

        def one(i: int) -> None:
            family, genus, epithet = todo[i]
            worker = workers[i % len(workers)]
            html_src, reason, url = worker.fetch(genus, epithet)
            traits = parse_environment(html_src) if html_src else None
            with write_lock:
                if traits is None:
                    err_writer.writerow([genus, epithet, reason or "invalid_page"])
                else:
                    out_writer.writerow({
                        "family": family, "genus": genus.lower(),
                        "species": epithet.lower(), **traits,
                    })

        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(len(workers)) as pool:
            list(pool.map(one, range(len(todo))))
    return 0


def main(argv: list[str] | None = None) -> None:
    from ...utils import cli

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
    cli.run({"scrape": scrape}, argv)


if __name__ == "__main__":
    main()
