# Verbatim copy of theoremsearch_tpu/ingest/latex/numbering.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""amsthm counter simulation.

Independent re-implementation of the numbering semantics the reference
encodes in TheoremNumberer (ec2/parse_papers/theorem_forms.py:13-136):

- \\newtheorem{env}[shared]{Caption}[within] -> env uses counter `shared`
  (if given) or its own counter, reset whenever `within` steps;
- \\numberwithin{child}{parent} rewires reset relationships;
- structural counters (section/subsection/subsubsection) cascade resets
  to all descendant counters;
- starred environments are unnumbered (caption + optional note only);
- appendix mode renders configured root counters as A, B, C, ... (AA
  after Z), descendants stay numeric (A.1.2);
- \\swapnumbers puts the number before the caption.

Headings are rendered "Caption N.M." (+ " (note)"), matching what the
reference stores in the theorem.name column.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def to_alpha(n: int) -> str:
    """1 -> A ... 26 -> Z, 27 -> AA (Excel-column style)."""
    if n <= 0:
        return "A"
    out = []
    while n > 0:
        n, rem = divmod(n - 1, 26)
        out.append(chr(ord("A") + rem))
    return "".join(reversed(out))


@dataclass
class EnvDef:
    caption: str
    counter: str | None       # None = unnumbered (starred)


@dataclass
class CounterTree:
    """Counter values + reset hierarchy + environment definitions."""

    values: dict[str, int] = field(default_factory=dict)
    parent: dict[str, str] = field(default_factory=dict)
    envs: dict[str, EnvDef] = field(default_factory=dict)
    swap_numbers: bool = False
    in_appendix: bool = False
    alpha_counters: frozenset = frozenset({"section"})

    def __post_init__(self) -> None:
        # LaTeX's built-in sectioning hierarchy: \thesubsection =
        # \thesection.\arabic{subsection} and a new \section resets
        # subsection — a theorem numbered [subsection] must render the
        # full "2.4.1" chain and restart at section boundaries.
        # (chapter->section wires lazily in step_structural: article-class
        # papers have no chapter counter and must NOT render "0.2".)
        for child, par in (
            ("subsection", "section"),
            ("subsubsection", "subsection"),
            ("paragraph", "subsubsection"),
        ):
            self.parent.setdefault(child, par)

    # ---- definitions ----

    def define_env(
        self,
        env: str,
        caption: str | None = None,
        *,
        starred: bool = False,
        shared: str | None = None,
        within: str | None = None,
    ) -> None:
        """First definition wins (matching amsthm erroring on redefinition
        and the reference returning early, theorem_forms.py:28-29)."""
        if env in self.envs:
            return
        caption = caption or env.capitalize()
        if starred:
            self.envs[env] = EnvDef(caption, None)
            return
        counter = shared or env
        self.envs[env] = EnvDef(caption, counter)
        self.values.setdefault(counter, 0)
        if within:
            self.values.setdefault(within, 0)
            self.parent[counter] = within

    def number_within(self, child: str, parent: str) -> None:
        self.values.setdefault(child, 0)
        self.values.setdefault(parent, 0)
        self.parent[child] = parent

    # ---- document events ----

    def step_structural(self, counter: str) -> None:
        """\\section etc.: advance and zero every descendant counter."""
        if counter == "chapter":
            # book/report class: sections number within chapters; wired
            # on first \chapter so article-class papers never render a
            # phantom "0." chapter component
            self.parent.setdefault("section", "chapter")
        self.values[counter] = self.values.get(counter, 0) + 1
        for child in self._descendants(counter):
            self.values[child] = 0

    def enter_appendix(self) -> None:
        self.in_appendix = True
        for c in self.alpha_counters:
            self.values[c] = 0
            for child in self._descendants(c):
                self.values[child] = 0

    def begin_env(self, env: str, note: str | None = None) -> str:
        """\\begin{env}[note] -> rendered heading."""
        spec = self.envs.get(env)
        if spec is None:
            self.define_env(env)
            spec = self.envs[env]
        if spec.counter is None:
            head = spec.caption
        else:
            self.values[spec.counter] = self.values.get(spec.counter, 0) + 1
            num = self._render(spec.counter)
            head = f"{num} {spec.caption}" if self.swap_numbers else f"{spec.caption} {num}"
        if note:
            head += f" ({note})"
        return head

    # ---- internals ----

    def _descendants(self, counter: str):
        out = []
        frontier = [counter]
        while frontier:
            cur = frontier.pop()
            for child, par in self.parent.items():
                if par == cur and child not in out:
                    out.append(child)
                    frontier.append(child)
        return out

    def _chain(self, counter: str) -> list[str]:
        chain = [counter]
        seen = {counter}
        while chain[-1] in self.parent:
            nxt = self.parent[chain[-1]]
            if nxt in seen:
                break
            chain.append(nxt)
            seen.add(nxt)
        chain.reverse()
        return chain

    def _render(self, counter: str) -> str:
        parts = []
        for c in self._chain(counter):
            v = self.values.get(c, 0)
            if self.in_appendix and c in self.alpha_counters:
                parts.append(to_alpha(v))
            else:
                parts.append(str(v))
        return ".".join(parts) + "."
