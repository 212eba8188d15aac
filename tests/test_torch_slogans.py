"""Slogans and the quality probes on both packages: prompt configs, the
offline client, paged generation with retry and resume, JSONL traces, the
batch JSONL build and ingest, cost tracking (the cases of
tests/test_slogans.py), and the slogan-quality judge and source-mismatch
estimator of tests/test_pipeline_e2e.py. Each case runs on the reference
package and on the port with the same inputs: equal catalog rows, equal
results, and the reference test's own checks on the port's."""

import gzip
import json

import pytest

from torch_helpers import twin


def _fill(cat, n=5):
    for i in range(n):
        cat.upsert_paper({
            "paper_id": f"2401.{i:05d}", "title": f"P{i}", "authors": [f"A{i}"],
            "summary": f"paper summary {i}", "link": "https://arxiv.org/abs/x",
            "last_updated": "2024-01-01", "journal_ref": None, "primary_category": "math.AG",
            "categories": ["math.AG"], "citations": i})
        cat.replace_theorems(
            f"2401.{i:05d}",
            [{"name": "Theorem 1.", "body": f"Let $x_{i} > 0$. Then $x^2 \\geq 0$. This is fact {i}."}],
            "scanner")
    return cat


def _slogans(cat):
    return sorted(tuple(r) for r in cat.conn.execute("SELECT * FROM theorem_slogan"))


def test_load_prompt_builtin_and_file_twin(tmp_path):
    custom = {"prompt_id": "custom-v1", "instructions": ["Do a thing."],
              "context": ["theorem.body", "paper.summary"], "temperature": 0.7}
    f = tmp_path / "custom-v1.prompt"
    f.write_text(json.dumps(custom))

    def case(p):
        load = p("slogans").load_prompt
        with pytest.raises(FileNotFoundError):
            load("nope-v9")
        return [(c.prompt_id, c.instructions, c.context_fields, c.temperature)
                for c in (load("body-only-v1"), load(str(f)), load("custom-v1", prompts_dir=tmp_path))]

    (pid, _, fields, _), (_, _, fields2, temp2), (pid3, _, _, _) = twin(case)
    assert pid == "body-only-v1" and fields == [("theorem", "body")]
    assert temp2 == 0.7 and ("paper", "summary") in fields2 and pid3 == "custom-v1"


def test_shipped_prompt_configs_load_twin():
    """The three versioned .prompt files resolve from each package's own
    prompt_configs/ (the port's copy, next to its slogans/prompts.py)."""
    def case(p):
        pr = p("slogans.prompts")
        assert pr.SHIPPED_PROMPTS_DIR.parent.parent.name == p.name
        return [(c.prompt_id, c.instructions, c.context, c.temperature) for c in
                (pr.load_prompt(pid) for pid in
                 ("body-only-v1", "body-and-abstract-v1", "body-and-introduction-v1"))]

    for pid, instructions, context, _ in twin(case):
        assert instructions and all("." in c for c in context)


def test_offline_stub_strips_latex_twin():
    payload = {"theorem_body": r"Let $G$ be a group. Then \emph{every} subgroup of $G$ is nice."}

    def case(p):
        c = p("slogans").OfflineStubClient().complete([], payload, 0.2)
        return c.text, c.input_tokens, c.output_tokens, c.cost_usd

    text, _, _, cost = twin(case)
    assert text and "$" not in text and "subgroup" in text and cost == 0.0


def test_generate_slogans_end_to_end_twin(tmp_path):
    """Paged generation (page_size 2) with a JSONL trace, then a resume
    that has nothing left to do."""
    def case(p):
        s = p("slogans")
        cat = _fill(p.catalog())
        trace = tmp_path / f"{p.name}.jsonl"
        tracer = p("utils.tracing").JsonlTracer(trace)
        cost = s.generate_slogans(cat, s.load_prompt("body-and-summary-v1"), s.OfflineStubClient(),
                                  page_size=2, tracer=tracer)
        cost2 = s.generate_slogans(cat, s.load_prompt("body-and-summary-v1"), s.OfflineStubClient())
        recs = [json.loads(ln) for ln in trace.read_text().splitlines()]
        return (cost.summary(), cost2.calls, _slogans(cat),
                sorted((r["type"], r["name"], r["theorem_id"], r["prompt_id"], r["model"]) for r in recs),
                all(r["latency_s"] >= 0 for r in recs))

    summary, calls2, rows, recs, lat_ok = twin(case)
    assert summary["calls"] == 5 and calls2 == 0 and len(rows) == 5
    assert len(recs) == 5 and recs[0][3] == "body-and-summary-v1" and lat_ok


def test_generate_slogans_retry_twin():
    def case(p):
        cat = p.catalog()
        cat.upsert_paper({"paper_id": "p1", "title": "t", "authors": [], "summary": "", "link": "",
                          "last_updated": "", "journal_ref": None, "primary_category": "",
                          "categories": [], "citations": 0})
        cat.replace_theorems("p1", [{"name": "Theorem 1.", "body": "b"}], "scanner")
        completion = p("slogans.client").Completion

        class Flaky:
            model_name = "flaky"

            def __init__(self):
                self.n = 0

            def complete(self, instructions, payload, temperature):
                self.n += 1
                if self.n == 1:
                    raise RuntimeError("transient")
                return completion("ok", 1, 1, 0.0)

        flaky = Flaky()
        p("slogans").generate_slogans(cat, p("slogans").load_prompt("body-only-v1"), flaky,
                                      max_retries=2)
        return flaky.n, _slogans(cat)

    n, rows = twin(case)
    assert n == 2 and len(rows) == 1 and rows[0][2:] == ("flaky", "body-only-v1", "ok")


def test_generate_slogans_threads_and_limit_twin():
    """16 worker threads over 40 theorems in pages of 7, a limit of 23
    first: the same rows in both packages, one slogan per theorem."""
    def case(p):
        s = p("slogans")
        cat = _fill(p.catalog(), 40)
        first = s.generate_slogans(cat, s.load_prompt("body-only-v1"), s.OfflineStubClient(),
                                   page_size=7, workers=16, limit=23)
        rest = s.generate_slogans(cat, s.load_prompt("body-only-v1"), s.OfflineStubClient(),
                                  page_size=7, workers=16)
        return first.calls, rest.calls, _slogans(cat)

    first, rest, rows = twin(case)
    assert (first, rest) == (23, 17) and len({r[1] for r in rows}) == len(rows) == 40


def test_batch_build_and_ingest_twin(tmp_path):
    def case(p):
        s, batch = p("slogans"), p("slogans.batch")
        cat = _fill(p.catalog())
        d = tmp_path / p.name
        parts = batch.build_batch_prompts(cat, s.load_prompt("body-only-v1"), "DeepSeek-V3.1", d,
                                          records_per_part=2)
        recs = [json.loads(ln) for part in parts for ln in part.read_text().splitlines()]
        out = d / "out"
        out.mkdir()
        (out / "results.jsonl").write_text("\n".join(json.dumps({
            "recordId": r["recordId"],
            "modelOutput": {"choices": [{"message": {"content": f"slogan for {r['recordId']}"}}]},
        }) for r in recs))
        n = batch.ingest_batch_results(cat, out, "DeepSeek-V3.1", "body-only-v1")
        # record ids carry a random run id: compare what they index
        return (len(parts), [r["modelInput"]["messages"][0]["role"] for r in recs], n,
                [row[:4] for row in _slogans(cat)])

    n_parts, roles, n, rows = twin(case)
    assert n_parts == 3 and roles[0] == "user" and n == 5 and len(rows) == 5


def test_cost_tracker_twin():
    def case(p):
        s = p("slogans")
        c = s.CostTracker()
        c.add(1000, 500, 0.01)
        c.add(1000, 500, 0.03)
        return round(c.total_usd, 12), round(c.avg_usd, 12), s.format_usd(0.5), c.summary()

    total, avg, usd, summary = twin(case)
    assert total == pytest.approx(0.04) and avg == pytest.approx(0.02)
    assert usd == "$0.500000" and summary["calls"] == 2


def test_tracers_twin(tmp_path):
    """get_tracer: jsonl appends one record a span or event at each flush,
    an error inside a span is recorded and re-raised; langfuse (absent)
    and None give the null tracer."""
    def case(p):
        tr = p("utils.tracing")
        path = tmp_path / f"{p.name}.jsonl"
        t = tr.get_tracer("jsonl", path)
        with t.span("a", k=1):
            pass
        t.event("e", v=2)
        with pytest.raises(ValueError):
            with t.span("b"):
                raise ValueError("boom")
        t.flush()
        t.flush()
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        return ([(r["type"], r["name"], r.get("k"), r.get("v"), r.get("error")) for r in recs],
                type(tr.get_tracer("langfuse")).__name__, type(tr.get_tracer(None)).__name__)

    recs, lf, none = twin(case)
    assert recs == [("span", "a", 1, None, None), ("event", "e", None, 2, None),
                    ("span", "b", None, None, "boom")]
    assert lf == none == "NullTracer"


def test_progress_twin():
    """utils.progress wraps an iterable (tqdm when installed, else the
    iterable itself) and yields the same items."""
    twin(lambda p: list(p("utils.progress").progress(range(5), total=5, desc="x")))


# ------------------------------------------------------- quality probes

TOPICS = ["prime numbers", "graph colorings", "elliptic curves", "banach spaces", "random walks"]


def _paper_tex(i):
    return ("\\documentclass{article}\n\\newtheorem{theorem}{Theorem}[section]\n"
            "\\begin{document}\\section{Intro}\n"
            f"\\begin{{theorem}}\\label{{t{i}}} Every result about {TOPICS[i % 5]} "
            f"holds with constant {i}. \\end{{theorem}}\n\\end{{document}}\n").encode()


def _full_catalog(p):
    cat = p.catalog()
    sources = {}
    for i in range(10):
        pid = f"2401.{i:05d}"
        cat.upsert_paper({
            "paper_id": pid, "title": f"A paper on {TOPICS[i % 5]}", "authors": [f"Author {i % 3}"],
            "summary": f"We study {TOPICS[i % 5]}.", "link": f"https://arxiv.org/abs/{pid}",
            "last_updated": "2024-01-01", "journal_ref": "J" if i % 2 else None,
            "primary_category": "math.NT", "categories": ["math.NT"], "citations": 10 * i})
        sources[pid] = gzip.compress(_paper_tex(i))
    stats = p("ingest.parse_driver").parse_papers(cat, source_fetcher=lambda pid: sources[pid],
                                                  timeout_s=30)
    assert stats.parsed == 10
    s = p("slogans")
    s.generate_slogans(cat, s.load_prompt("body-only-v1"), s.OfflineStubClient())
    return cat


def test_quality_probes_twin():
    """rate_slogans_quality with the offline judge (no ratings: it echoes
    text) and with a fake judge over every slogan (sample_size >= the
    slogan count, so ORDER BY RANDOM() samples the whole table): the
    sorted ratings and flags equal; parse_rating's cases."""
    def case(p):
        q = p("eval.quality")
        cat = _full_catalog(p)
        completion = p("slogans.client").Completion

        class FakeJudge:
            model_name = "fake-judge"

            def complete(self, instructions, payload, temperature):
                slogan = payload.get("slogan") or ""
                r = 5 if "constant" in slogan and "prime" not in slogan else 2
                return completion(json.dumps({"rating": r, "reason": "x"}), 1, 1, 0.0)

        stub = q.rate_slogans_quality(cat, sample_size=5)
        report = q.rate_slogans_quality(cat, judge=FakeJudge(), sample_size=50)
        return (stub.ratings, sorted(report.ratings), sorted(report.flagged), report.mean,
                [q.parse_rating(t) for t in ('{"rating": 3, "reason": "ok"}',
                                             'the rating is {"rating": 4}', "garbage", None)])

    stub, ratings, flagged, mean, parsed = twin(case)
    assert stub == [] and len(ratings) == 10 and ratings.count(2) == 2
    assert [r for _, r in flagged] == [2, 2] and mean == pytest.approx(4.4)
    assert parsed == [3, 4, None, None]


def test_mismatch_estimator_twin(tmp_path):
    for side in ("a", "b"):
        (tmp_path / side / "tags").mkdir(parents=True)
        (tmp_path / side / "main.tex").write_text("x")
    (tmp_path / "b" / "tags" / "extra.tex").write_text("y")

    def case(p):
        q = p("eval.quality")
        est = q.estimate_source_mismatch([f"p{i}" for i in range(100)],
                                         compare_fn=lambda pid: int(pid[1:]) % 10 != 0)
        sampled = q.estimate_source_mismatch([f"p{i}" for i in range(100)],
                                             compare_fn=lambda pid: int(pid[1:]) % 2 == 0,
                                             sample_size=30, seed=4)
        return (est.n, est.mismatches, est.ci95, est.summary(), q.MismatchEstimate(0, 0).ci95,
                sampled.n, sampled.mismatches,
                q.trees_equal(tmp_path / "a", tmp_path / "a"), q.trees_equal(tmp_path / "a", tmp_path / "b"))

    n, mism, (lo, hi), summary, empty, sn, _, same, differ = twin(case)
    assert n == 100 and mism == 10 and lo < 0.1 < hi and "p̂=0.100" in summary
    assert empty == (0.0, 0.0) and sn == 30 and same and not differ
