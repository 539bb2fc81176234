"""Semantic response cache (experimental, behind --feature-gates SemanticCache=true).

The port's copy of ``production_stack_tpu/router/semantic_cache.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/experimental/semantic_cache/ of the upstream vLLM production stack
(SemanticCache semantic_cache.py:16-120+, FAISSAdapter db_adapters/
faiss_adapter.py:14-134, integration check/store hooks).

Backends are optional-import, mirroring the reference's dependency split
(pyproject extra ``semantic_cache``): when ``sentence-transformers`` is
installed the embedder is a real sentence encoder, and when ``faiss`` is
installed similarity search runs on an ``IndexFlatIP``. Neither ships in
hermetic environments, so the always-available fallbacks are a hashed
character-n-gram featurizer (deterministic, dependency-free) and exact
brute-force cosine search over a numpy matrix — same interfaces, proven by
the unit tests with fake modules.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Callable, Optional

import numpy as np

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

DIM = 256


def ngram_hash_embed(text: str, dim: int = DIM) -> np.ndarray:
    """Hashed char-3gram bag embedding, L2-normalized."""
    v = np.zeros(dim, np.float32)
    t = text.lower()
    for i in range(max(len(t) - 2, 1)):
        g = t[i : i + 3]
        h = int.from_bytes(hashlib.blake2b(g.encode(), digest_size=4).digest(), "little")
        v[h % dim] += 1.0
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


class SentenceTransformerEmbedder:
    """Real sentence encoder (reference: semantic_cache.py uses
    sentence-transformers). Activates when the package is installed; inject
    ``module`` to test the adapter without it."""

    def __init__(self, model_name: str = "all-MiniLM-L6-v2", module=None):
        if module is None:
            import sentence_transformers as module  # optional dep
        self._model = module.SentenceTransformer(model_name)
        self.dim = int(self._model.get_sentence_embedding_dimension())

    def __call__(self, text: str) -> np.ndarray:
        v = np.asarray(self._model.encode([text])[0], np.float32)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v


class NumpyIndex:
    """Exact brute-force cosine search (vectors pre-normalized)."""

    def __init__(self, dim: int):
        self.vectors = np.zeros((0, dim), np.float32)

    def __len__(self) -> int:
        return len(self.vectors)

    def add(self, v: np.ndarray) -> None:
        self.vectors = np.vstack([self.vectors, v[None]])

    def search(self, q: np.ndarray) -> "tuple[float, int]":
        if not len(self.vectors):
            return -1.0, -1
        sims = self.vectors @ q
        best = int(np.argmax(sims))
        return float(sims[best]), best

    def pop_front(self, k: int = 1) -> None:
        self.vectors = self.vectors[k:]


class FaissIndex:
    """FAISS ``IndexFlatIP`` adapter (reference: faiss_adapter.py:14-134 —
    inner product over normalized vectors == cosine). Inject ``module`` to
    test without faiss installed."""

    def __init__(self, dim: int, module=None):
        if module is None:
            import faiss as module  # optional dep
        self._faiss = module
        self.dim = dim
        self._index = module.IndexFlatIP(dim)
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def add(self, v: np.ndarray) -> None:
        self._index.add(np.ascontiguousarray(v[None], np.float32))
        self._count += 1

    def search(self, q: np.ndarray) -> "tuple[float, int]":
        if not self._count:
            return -1.0, -1
        sims, ids = self._index.search(np.ascontiguousarray(q[None], np.float32), 1)
        return float(sims[0, 0]), int(ids[0, 0])

    def pop_front(self, k: int = 1) -> None:
        # IndexFlatIP stores vectors densely: eviction is an O(n*dim) rebuild
        # without the dropped rows, so callers evict in batches to keep the
        # steady-state store path O(1) amortized.
        n = self._count
        k = min(k, n)
        kept = np.vstack(
            [self._index.reconstruct(i) for i in range(k, n)]
        ) if n > k else np.zeros((0, self.dim), np.float32)
        self._index = self._faiss.IndexFlatIP(self.dim)
        if len(kept):
            self._index.add(np.ascontiguousarray(kept, np.float32))
        self._count = n - k


def default_embedder() -> "tuple[Callable[[str], np.ndarray], int]":
    """(embed_fn, dim): sentence-transformers when installed AND its model is
    already cached locally, else n-grams. The probe runs HF-offline so a
    router in an air-gapped cluster fails fast to the fallback instead of
    stalling startup on download retries; pre-download the model (or bake it
    into the image) to activate the real embedder."""
    import os

    prev = os.environ.get("HF_HUB_OFFLINE")
    os.environ["HF_HUB_OFFLINE"] = "1"
    try:
        emb = SentenceTransformerEmbedder()
        logger.info("semantic cache: sentence-transformers embedder (dim=%d)", emb.dim)
        return emb, emb.dim
    except Exception:  # noqa: BLE001 - package absent or model not cached
        return ngram_hash_embed, DIM
    finally:
        if prev is None:
            os.environ.pop("HF_HUB_OFFLINE", None)
        else:
            os.environ["HF_HUB_OFFLINE"] = prev


def default_index(dim: int):
    """FAISS IndexFlatIP when installed, else exact numpy search."""
    try:
        idx = FaissIndex(dim)
        logger.info("semantic cache: FAISS IndexFlatIP backend")
        return idx
    except Exception:  # noqa: BLE001
        return NumpyIndex(dim)


class SemanticCache:
    def __init__(
        self,
        threshold: float = 0.92,
        max_entries: int = 4096,
        embed: Optional[Callable[[str], np.ndarray]] = None,
        index=None,
    ):
        self.threshold = threshold
        self.max_entries = max_entries
        if embed is None:
            embed, dim = default_embedder()
        else:
            dim = getattr(embed, "dim", DIM)
        self.embed = embed
        self.index = index if index is not None else default_index(dim)
        self.entries: list[dict] = []
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _prompt_of(body: bytes) -> Optional[str]:
        try:
            data = json.loads(body)
        except json.JSONDecodeError:
            return None
        msgs = data.get("messages")
        if not msgs or data.get("stream"):
            return None  # only cache non-streaming chat requests
        return json.dumps(msgs, sort_keys=True)

    async def check(self, body: bytes) -> Optional[dict]:
        prompt = self._prompt_of(body)
        if prompt is None or len(self.entries) == 0:
            self.misses += 1
            return None
        sim, best = self.index.search(self.embed(prompt))
        if best >= 0 and sim >= self.threshold:
            self.hits += 1
            logger.info("semantic cache hit (sim=%.3f)", sim)
            return self.entries[best]["response"]
        self.misses += 1
        return None

    async def store(self, body: bytes, response: dict) -> None:
        prompt = self._prompt_of(body)
        if prompt is None:
            return
        self.index.add(self.embed(prompt))
        self.entries.append({"response": response, "ts": time.time()})
        if len(self.entries) > self.max_entries:
            # Batch-evict the oldest eighth: a FAISS flat index can only
            # evict via full rebuild, so amortize that cost over many stores
            # instead of paying O(n*dim) on every miss once the cache fills.
            k = max(1, self.max_entries // 8)
            self.index.pop_front(k)
            del self.entries[:k]
