"""Streamlit frontend (optional) of the port (counterpart of
theoremsearch_tpu/serve/ui.py): sidebar with the full filter set
(sources, authors, tags-per-source, year range, journal status, paper
id/title filter, result types, citation range + unknown toggle, top-k,
citation weight), result expanders with slogan + cleaned LaTeX body, and
working thumbs-up/down feedback.

Run:  streamlit run -m theoremsearch_tpu_torch.serve.ui  (or point
streamlit at this file) with env THEOREMSEARCH_CATALOG /
THEOREMSEARCH_SPOOL (and THEOREMSEARCH_MODEL_DIR /
THEOREMSEARCH_EMBEDDER) set. The engine and the encoder run on the card.
"""

from __future__ import annotations

import os


def build_service(device=None):
    """The SearchService the UI queries: the encoder of
    THEOREMSEARCH_MODEL_DIR (or the hermetic one of THEOREMSEARCH_EMBEDDER)
    and the engine built from THEOREMSEARCH_CATALOG and THEOREMSEARCH_SPOOL,
    on `device` (default: the card; "cpu" for a CPU run)."""
    from argparse import Namespace

    from ..cli import _batched_encoder
    from ..ingest.catalog import Catalog
    from ..pipeline import build_engine_from_catalog
    from .app import SearchService

    be = _batched_encoder(Namespace(model_dir=os.environ.get("THEOREMSEARCH_MODEL_DIR"),
                                    embedder=os.environ.get("THEOREMSEARCH_EMBEDDER", "qwen"),
                                    device=device))
    catalog = Catalog(os.environ.get("THEOREMSEARCH_CATALOG", "catalog.db"))
    # documents embed with the document role prompt, queries with the
    # query one (asymmetric-prompt checkpoints, same split as cmd_serve)
    engine = build_engine_from_catalog(
        catalog, be.for_role("document"),
        os.environ.get("THEOREMSEARCH_SPOOL", "./spool"), device=be.device,
    )
    return SearchService(engine, be.for_role("query"), feedback_path="feedback.jsonl")


def main():  # pragma: no cover - requires streamlit runtime
    import streamlit as st

    from ..search.filters import ALLOWED_TYPES, SearchFilters, parse_paper_filter

    st.set_page_config(page_title="Theorem Search (GPU)", layout="wide")
    st.title("Math Theorem Search — CUDA engine")

    @st.cache_resource
    def _svc():
        svc = build_service()
        # once per process (cache_resource): freeze the engine/encoder/
        # metadata graph out of GC scans — a gen-2 pass over it stalls
        # every thread ~300 ms at 1M rows (utils/gc_tuning.py)
        from ..utils.gc_tuning import freeze_permanent

        freeze_permanent()
        return svc

    svc = _svc()
    st.write(f"Searching {svc.load_theorem_count():,} theorems semantically.")

    with st.sidebar:
        sources = st.multiselect(
            "Sources", ["arXiv", "Stacks Project"], default=["arXiv", "Stacks Project"]
        )
        tags_per_source = svc.load_tags_per_source()
        tag_options = sorted({t for src in sources for t in tags_per_source.get(src, [])})
        tags = st.multiselect("Tags", tag_options)
        authors = st.multiselect("Authors", svc.load_authors())
        year_range = st.slider("Year (arXiv)", 1992, 2026, (1992, 2026))
        journal_status = st.selectbox("Journal status", ["All", "Journal Article", "Preprint Only"])
        paper_filter_raw = st.text_input("Paper filter (arXiv ids / title substrings)")
        types = st.multiselect("Result types", ALLOWED_TYPES)
        citation_range = st.slider("Citations", 0, 10_000, (0, 10_000))
        include_unknown = st.checkbox("Include unknown citation counts", True)
        top_k = st.number_input("Results", 1, 100, 10)
        citation_weight = st.slider("Citation weight", 0.0, 1.0, 0.0)

    query = st.text_input("Describe the theorem you're looking for")
    if st.button("Search") and query:
        if not sources:
            st.warning("Please select at least one source.")
            return
        filters = SearchFilters(
            sources=sources,
            authors=authors,
            tags=tags,
            year_range=year_range,
            journal_status=journal_status,
            paper_filter=parse_paper_filter(paper_filter_raw),
            types=types,
            citation_range=citation_range,
            include_unknown_citations=include_unknown,
            top_k=int(top_k),
            citation_weight=float(citation_weight),
        )
        results = svc.search_and_display(query, filters)
        st.subheader(f"Found {len(results)} Matching Results")
        if not results:
            st.warning("No results found for the current filters.")
        for i, info in enumerate(results):
            title = f"**Result {i + 1} | Similarity: {info['score']:.4f} | {info['type'].title()}**"
            with st.expander(title, expanded=True):
                st.markdown(f"**Paper:** *{info['paper_title'] or 'Unknown'}*")
                st.markdown(f"**Authors:** {', '.join(info['authors'] or []) or 'N/A'}")
                st.markdown(f"**Source:** {info['source']}  |  [{info['paper_url']}]({info['paper_url']})")
                cit = info["citations"]
                st.markdown(
                    f"**Tag:** `{info['primary_category']}` | "
                    f"**Citations:** {'Unknown' if cit is None else cit} | "
                    f"**Year:** {info['year'] or 'N/A'}"
                )
                if info.get("theorem_slogan"):
                    st.markdown(f"**Slogan:** {info['theorem_slogan']}")
                st.markdown(f"**{info['theorem_name'] or 'Theorem Body.'}**")
                st.markdown(info["display_markdown"])
                c1, c2 = st.columns(2)
                voted_text = info.get("theorem_slogan") or info.get("theorem_body")
                if c1.button("👍", key=f"up_{i}"):
                    svc.save_feedback(
                        "up", query, info["paper_url"], info["theorem_name"],
                        filters, text=voted_text,
                    )
                if c2.button("👎", key=f"down_{i}"):
                    svc.save_feedback(
                        "down", query, info["paper_url"], info["theorem_name"],
                        filters, text=voted_text,
                    )


if __name__ == "__main__":  # pragma: no cover
    main()
