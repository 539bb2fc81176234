"""Chunked hash trie for prefix-aware routing.

The port's copy of ``production_stack_tpu/router/hashtrie.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/prefix/hashtrie.py of the upstream vLLM production stack (chunk size 128
chars :36, insert :58, longest_prefix_match :76-103). blake2b replaces xxhash
(not in this environment); same structure: each trie level keys on the hash of
one 128-char chunk, nodes remember which endpoints have seen that prefix.
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import Optional


def _chunk_hash(chunk: str) -> int:
    return int.from_bytes(hashlib.blake2b(chunk.encode(), digest_size=8).digest(), "little")


class TrieNode:
    __slots__ = ("children", "endpoints", "lock")

    def __init__(self):
        self.children: dict[int, TrieNode] = {}
        self.endpoints: set[str] = set()
        self.lock = asyncio.Lock()


class HashTrie:
    def __init__(self, chunk_size: int = 128):
        self.root = TrieNode()
        self.chunk_size = chunk_size

    def _chunks(self, text: str):
        for i in range(0, len(text), self.chunk_size):
            yield _chunk_hash(text[i : i + self.chunk_size])

    async def insert(self, text: str, endpoint: str) -> None:
        node = self.root
        async with node.lock:
            node.endpoints.add(endpoint)
        for h in self._chunks(text):
            async with node.lock:
                nxt = node.children.get(h)
                if nxt is None:
                    nxt = node.children[h] = TrieNode()
            async with nxt.lock:
                nxt.endpoints.add(endpoint)
            node = nxt

    async def longest_prefix_match(
        self, text: str, available: Optional[set[str]] = None
    ) -> tuple[int, set[str]]:
        """Returns (matched_chars, endpoints at the deepest matched node,
        filtered by `available`)."""
        node = self.root
        matched = 0
        selected: set[str] = set()
        for i, h in enumerate(self._chunks(text)):
            nxt = node.children.get(h)
            if nxt is None:
                break
            eps = nxt.endpoints if available is None else (nxt.endpoints & available)
            if not eps:
                break
            matched = min((i + 1) * self.chunk_size, len(text))
            selected = set(eps)
            node = nxt
        if not selected and available:
            selected = set(available)
        return matched, selected

    async def remove_endpoint(self, endpoint: str) -> None:
        stack = [self.root]
        while stack:
            node = stack.pop()
            node.endpoints.discard(endpoint)
            stack.extend(node.children.values())
