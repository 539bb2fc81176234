"""PII detection middleware (experimental, behind --feature-gates PIIDetection=true).

The port's copy of ``production_stack_tpu/router/pii.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/experimental/pii/ of the upstream vLLM production stack —
check_pii_content middleware.py:43-154, RegexAnalyzer analyzers/regex.py:22,
PresidioAnalyzer analyzers/presidio.py:45. Presidio is optional-import in
the reference and here alike (pyproject extra ``pii``): ``make_analyzer``
returns the Presidio tier when the package is installed and the regex
analyzer otherwise.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

PATTERNS: dict[str, re.Pattern] = {
    "EMAIL": re.compile(r"[a-zA-Z0-9_.+-]+@[a-zA-Z0-9-]+\.[a-zA-Z0-9-.]+"),
    "PHONE": re.compile(r"\+?\d[\d\s().-]{7,}\d"),
    "SSN": re.compile(r"\b\d{3}-\d{2}-\d{4}\b"),
    "CREDIT_CARD": re.compile(r"\b(?:\d[ -]*?){13,16}\b"),
    "IP_ADDRESS": re.compile(r"\b(?:\d{1,3}\.){3}\d{1,3}\b"),
    "API_KEY": re.compile(r"\b(?:sk|pk|rk)-[A-Za-z0-9]{16,}\b"),
}


@dataclasses.dataclass
class PIIMatch:
    kind: str
    start: int
    end: int
    text: str


class RegexAnalyzer:
    def analyze(self, text: str) -> list[PIIMatch]:
        out = []
        for kind, pat in PATTERNS.items():
            for m in pat.finditer(text):
                out.append(PIIMatch(kind, m.start(), m.end(), m.group()))
        return out


class PresidioAnalyzer:
    """Microsoft Presidio NER tier (reference: analyzers/presidio.py:45).
    Activates when ``presidio_analyzer`` is installed; inject ``engine`` to
    test the adapter without it."""

    def __init__(self, engine=None, language: str = "en"):
        if engine is None:
            from presidio_analyzer import AnalyzerEngine  # optional dep

            engine = AnalyzerEngine()
        self._engine = engine
        self.language = language

    def analyze(self, text: str) -> list[PIIMatch]:
        results = self._engine.analyze(text=text, language=self.language)
        return [
            PIIMatch(r.entity_type, r.start, r.end, text[r.start : r.end])
            for r in results
        ]


_analyzer = None


def make_analyzer(kind: str = "auto"):
    """regex | presidio | auto (presidio when installed, else regex)."""
    if kind in ("auto", "presidio"):
        try:
            a = PresidioAnalyzer()
            logger.info("PII detection: Presidio analyzer")
            return a
        except Exception as e:  # noqa: BLE001 - package absent
            if kind == "presidio":
                raise RuntimeError(
                    f"--pii-analyzer presidio requires presidio_analyzer: {e}"
                ) from e
    return RegexAnalyzer()


def check_pii_content(text: str, analyzer=None) -> list[PIIMatch]:
    global _analyzer
    if analyzer is None:
        if _analyzer is None:
            _analyzer = make_analyzer()
        analyzer = _analyzer
    return analyzer.analyze(text)


def redact(
    text: str, matches: Optional[list[PIIMatch]] = None, analyzer=None
) -> str:
    matches = matches if matches is not None else check_pii_content(text, analyzer)
    for m in sorted(matches, key=lambda m: -m.start):
        text = text[: m.start] + f"[{m.kind}]" + text[m.end :]
    return text
