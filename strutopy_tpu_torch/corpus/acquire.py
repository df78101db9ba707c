"""Data acquisition (a copy of ``strutopy_tpu/corpus/acquire.py``).

Loaders for texts in CSV or JSON (any table with a text column and
optional label columns enters ``corpus.preprocess.build_corpus`` ->
STM), and the wiki scraper, which writes ``wiki_corpus.csv`` with
columns (pageid, text, title, <one label per seed page>).  The scraper
takes an injectable ``fetch(url) -> bytes``; nothing here touches the
network unless the caller runs it without one.
"""

from __future__ import annotations

import csv
from typing import Sequence

from strutopy_tpu_torch.corpus.preprocess import build_corpus


def load_texts_csv(path: str, text_column: str = "text", label_columns: Sequence[str] = ()):
    """Load (texts, labels) from a CSV with the wiki_corpus.csv layout."""
    texts, labels = [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            texts.append(row[text_column])
            labels.append({c: row.get(c) for c in label_columns})
    return texts, labels


def load_texts_json(path: str, text_field: str = "text", label_fields: Sequence[str] = ()):
    """Load (texts, labels) from JSON: a list of objects, or JSON-lines."""
    import json

    with open(path) as f:
        # skip leading whitespace/BOM before dispatching array vs lines
        head = ""
        while True:
            ch = f.read(1)
            if not ch:
                break
            if not ch.isspace() and ch != "﻿":
                head = ch
                break
        f.seek(0)
        if head == "[":
            records = json.load(f)
        else:  # JSON lines
            records = [json.loads(line) for line in f if line.strip()]
    texts = [r[text_field] for r in records]
    labels = [{c: r.get(c) for c in label_fields} for r in records]
    return texts, labels


def corpus_from_csv(
    path: str,
    text_column: str = "text",
    label_columns: Sequence[str] = (),
    min_doc_freq: int = 2,
    max_doc_frac: float = 0.5,
):
    """CSV -> (bow, vocabulary, labels): loading and preprocessing in one
    call (punctuation/digit stripping and stopword removal)."""
    texts, labels = load_texts_csv(path, text_column, label_columns)
    bow, vocab = build_corpus(
        texts, min_doc_freq=min_doc_freq, max_doc_frac=max_doc_frac
    )
    return bow, vocab, labels


def _mediawiki_api(params: dict, fetch=None) -> dict:
    """One MediaWiki Action API call (en.wikipedia.org).

    ``fetch(url) -> bytes`` is injectable for tests / offline use;
    the default uses urllib (stdlib, no extra deps).
    """
    import json as _json
    import urllib.parse
    import urllib.request

    base = "https://en.wikipedia.org/w/api.php"
    q = dict(params, format="json", formatversion="2")
    url = base + "?" + urllib.parse.urlencode(q)
    if fetch is None:
        def fetch(u):
            req = urllib.request.Request(
                u, headers={"User-Agent": "strutopy_tpu_torch/0.1.0 (research)"}
            )
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.read()

    return _json.loads(fetch(url))


def _page_links(title: str, fetch=None):
    """All outgoing links of a page (follows plcontinue pagination)."""
    links, cont = [], {}
    while True:
        resp = _mediawiki_api(
            {"action": "query", "prop": "links", "titles": title,
             "pllimit": "max", **cont},
            fetch,
        )
        for page in resp.get("query", {}).get("pages", []):
            links.extend(l["title"] for l in page.get("links", []))
        cont = resp.get("continue")
        if not cont:
            return links
        cont = {k: v for k, v in cont.items() if k != "continue"}


def _page_summary(title: str, fetch=None):
    """(pageid, title, summary-extract) for one page; None if missing."""
    resp = _mediawiki_api(
        {"action": "query", "prop": "extracts", "exintro": "1",
         "explaintext": "1", "redirects": "1", "titles": title},
        fetch,
    )
    for page in resp.get("query", {}).get("pages", []):
        if page.get("missing") or "extract" not in page:
            return None
        return page["pageid"], page["title"], page["extract"]
    return None


def get_wiki_docs(
    output_dir: str = "artifacts/wiki_data",
    seed_pages: Sequence[str] = ("Statistics", "Machine learning"),
    exclude_prefixes: Sequence[str] = (
        "List of", "Lists of", "Glossary of", "ISBN", "ISSN", "ArXiv",
        "CiteSeerX", "OCLC", "S2CID", "PMC", "PMID", "Doi",
    ),
    max_pages_per_seed: int = 0,
    fetch=None,
):
    """Scrape the wiki corpus.

    For each seed page, fetch its outgoing links, drop non-content
    pages (identifier/list/glossary pages, by prefix), pull each linked
    page's intro summary, label it with one indicator column per seed,
    give pages reachable from several seeds all their labels, and write
    ``wiki_corpus.csv`` with columns (pageid, text, title, <labels>).

    Uses the MediaWiki Action API over stdlib urllib.  Pass ``fetch(url)->bytes``
    to stub the network (tests) or to add caching/throttling.
    ``max_pages_per_seed`` > 0 truncates each seed's link list (smoke
    runs).  Returns the list of (pageid, text, title, labels...) rows.
    """
    import os

    # first word of the seed title, deduped: colliding seeds (e.g.
    # "Machine learning" + "Machine vision") would otherwise share one
    # indicator column and merge their link graphs silently
    label_names = []
    for s in seed_pages:
        base = s.split()[0].lower()
        name = base
        k = 2
        while name in label_names:
            name = f"{base}{k}"
            k += 1
        label_names.append(name)
    by_pageid = {}
    errors = []
    for si, seed in enumerate(seed_pages):
        links = _page_links(seed, fetch)
        links = [
            l for l in links
            if not any(l.startswith(p) for p in exclude_prefixes)
        ]
        if max_pages_per_seed:
            links = links[:max_pages_per_seed]
        for link in links:
            try:
                got = _page_summary(link, fetch)
            except Exception:
                got = None
            if got is None:
                errors.append(link)
                continue
            pageid, title, text = got
            row = by_pageid.setdefault(
                pageid,
                {"pageid": pageid, "text": text, "title": title,
                 **{n: 0 for n in label_names}},
            )
            row[label_names[si]] = 1  # multi-seed pages keep all labels

    rows = list(by_pageid.values())
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, "wiki_corpus.csv")
    cols = ["pageid", "text", "title"] + label_names
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + cols)  # the CSV keeps an index column, as the JAX package's
        for i, r in enumerate(rows):
            w.writerow([i] + [r[c] for c in cols])
    if errors:
        import logging

        logging.getLogger(__name__).info(
            "get_wiki_docs: %d links failed/missing", len(errors)
        )
    return rows
